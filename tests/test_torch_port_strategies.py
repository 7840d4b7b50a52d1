"""kmpc_tpu_torch's strategies and the full Jacobi comparison against
kmpc_tpu's.

A small synthetic panel (40 rebalance dates, 8 assets, embedding 4) and a
narrow GenericKM whose kmpc_tpu weights are carried into the port. Both
sides solve through their fused path on the CPU: the Pallas kernels in
interpret mode, the CUDA kernels' plain PyTorch versions. Random streams
differ between the frameworks, so kmpc_tpu's scenarios are carried into the
port as numpy; DMD's operator is tested both fitted and carried over.

Bars: rolling moments and forecasts 1e-6 / 1e-5 (float32 sums in another
order); per-date targets at the kernel bars (log-utility 5e-4,
mean-variance 5e-5); backtest portfolio values rtol 1e-4 for Markowitz and
buy-and-hold (a real QP, the same recursion) and 1e-3 for the log-utility
strategies (weights may move along near-flat faces of the program, which
moves the costs slightly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.backtest import engine as J
from kmpc_tpu.ops.mpc import MPCParams as JParams
from kmpc_tpu_torch.backtest import engine as T
from kmpc_tpu_torch.ops.mpc import MPCParams

N_ASSETS, D, N_DATES, H, S = 8, 4, 40, 5, 4
MPC_KW = dict(max_iters=300, sigma_scale=2.0)
MV_KW = dict(max_iters=300, gamma=1.0, horizon=1)
SWEEPS = 3
NAMES = ["BuyAndHold", "Markowitz", "DMD", "KoopmanMPC", "ScenarioKelly"]


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _finance_data(pkg):
    """A synthetic FinanceData in kmpc_tpu ('jax') or kmpc_tpu_torch
    ('torch') form; the train split is longer than the observation is wide,
    as in the finance configs."""
    if pkg == "jax":
        from kmpc_tpu.data.finance import (
            FinanceData, FinanceStats, time_delay_embedding,
        )
        arr = jnp.asarray
    else:
        from kmpc_tpu_torch.data.finance import (
            FinanceData, FinanceStats, time_delay_embedding,
        )
        arr = _t

    rng = np.random.default_rng(0)
    n_test = N_DATES + 1 + H   # rows of the test split: dates + sequence_length + H
    n_train = 60
    rets = (rng.standard_normal((n_train + n_test, N_ASSETS)) * 0.01
            + 0.0003 * np.arange(N_ASSETS)).astype(np.float32)
    mean = rets[:n_train].mean(0)
    std = np.maximum(rets[:n_train].std(0), 1e-8)
    emb = time_delay_embedding((rets - mean) / std, D)
    split = n_train - (D - 1)
    dates = pd.bdate_range("2005-01-03", periods=len(emb))
    stats = FinanceStats(mean=mean, std=std,
                         tickers=[f"A{i}" for i in range(N_ASSETS)])
    meta = {"n_assets": N_ASSETS, "embedding_dim": D,
            "observation_size": D * N_ASSETS}
    return FinanceData(
        train=arr(emb[:split]), val=arr(emb[split - 30:split]),
        test=arr(emb[split:]), train_dates=dates[:split],
        val_dates=dates[split - 30:split], test_dates=dates[split:],
        stats=stats, metadata=meta, mean=arr(mean), std=arr(std),
        sequence_length=1,
    )


@pytest.fixture(scope="module")
def world():
    """Data, models and the five strategies of both packages. kmpc_tpu's
    scenarios and DMD operator are carried into the port's strategies."""
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu_torch.models.koopman import make_model as tmake
    from kmpc_tpu_torch.utils.params import params_from_jax

    cfgs = []
    for cfgmod in (jcfg, tcfg):
        cfg = cfgmod.get_config("generic")
        cfg.MODEL.TARGET_SIZE = 16
        cfg.MODEL.ENCODER.LAYERS = [32]
        cfg.MODEL.ENCODER.USE_BIAS = True
        cfgs.append(cfg)
    jm = jmake(cfgs[0], D * N_ASSETS)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params["kmat"] = (0.9 * np.eye(16) + 0.05 * rng.standard_normal((16, 16))
                      ).astype(np.float32)
    tm = tmake(cfgs[1], D * N_ASSETS, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tm.eval()
    fd_j, fd_t = _finance_data("jax"), _finance_data("torch")

    mpc_j, mpc_t = JParams(**MPC_KW), MPCParams(**MPC_KW)
    rstd = np.full((H, N_ASSETS), 0.004, np.float32)
    strat_j = {
        "BuyAndHold": J.BuyAndHoldStrategy(),
        "Markowitz": J.MarkowitzStrategy(mpc=JParams(**MV_KW),
                                         lookback_window=20,
                                         use_fused_kernel=True),
        "DMD": J.DMDStrategy(mpc=mpc_j, use_fused_kernel=True),
        "KoopmanMPC": J.KoopmanMPCStrategy(model=jm, params=params,
                                           mpc=mpc_j, use_fused_kernel=True),
        "ScenarioKelly": J.ScenarioKoopmanMPCStrategy(
            model=jm, params=params, mpc=mpc_j, num_scenarios=S,
            residual_std=jnp.asarray(rstd), use_fused_kernel=True),
    }
    strat_j["DMD"].fit(fd_j.train)
    scen = np.asarray(strat_j["ScenarioKelly"].precompute(fd_j, H)
                      ["scenario_log_returns"])
    strat_t = {
        "BuyAndHold": T.BuyAndHoldStrategy(),
        "Markowitz": T.MarkowitzStrategy(mpc=MPCParams(**MV_KW),
                                         lookback_window=20),
        "DMD": T.DMDStrategy(mpc=mpc_t, K=_t(strat_j["DMD"].K)),
        "KoopmanMPC": T.KoopmanMPCStrategy(model=tm, mpc=mpc_t),
        "ScenarioKelly": T.ScenarioKoopmanMPCStrategy(
            model=tm, mpc=mpc_t, num_scenarios=S, residual_std=_t(rstd)),
    }
    strat_t["ScenarioKelly"].precompute = \
        lambda fd, horizon: {"scenario_log_returns": _t(scen)}
    return dict(jm=jm, params=params, tm=tm, fd_j=fd_j, fd_t=fd_t,
                strat_j=strat_j, strat_t=strat_t, scen=scen, rstd=rstd)


def _guess(seed=1):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(N_ASSETS) * 5,
                         size=N_DATES + H + D).astype(np.float32)


def test_all_strategies_default_to_the_fused_path(world):
    for name in NAMES[1:]:
        assert world["strat_t"][name].use_fused_kernel is True


def test_markowitz_precompute_matches(world):
    aux_j = world["strat_j"]["Markowitz"].precompute(world["fd_j"], H)
    aux_t = world["strat_t"]["Markowitz"].precompute(world["fd_t"], H)
    assert set(aux_t) == set(aux_j) == {"mu", "sigma", "has_data"}
    np.testing.assert_allclose(aux_t["mu"].numpy(), np.asarray(aux_j["mu"]),
                               atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(aux_t["sigma"].numpy(),
                               np.asarray(aux_j["sigma"]), atol=1e-9,
                               rtol=1e-4)
    has = aux_t["has_data"].numpy()
    assert np.array_equal(has, np.asarray(aux_j["has_data"]))
    # The first four dates have fewer than five returns behind them.
    assert not has[:4].any() and has[4:].all()
    # Sample covariance (ddof 1) plus the ridge, checked at one date.
    rets = world["fd_t"].destandardize_returns(
        world["fd_t"].extract_current_returns(world["fd_t"].test)).numpy()
    want = np.cov(rets[30 - 19:31].T, ddof=1) + 1e-6 * np.eye(N_ASSETS)
    np.testing.assert_allclose(aux_t["sigma"][30].numpy(), want, atol=1e-8,
                               rtol=1e-3)


def test_markowitz_rebalance_all_matches(world):
    """Dates without data keep the guessed weights; the rest solve the
    mean-variance program (mean-variance kernel bar, 5e-5)."""
    sj, st = world["strat_j"]["Markowitz"], world["strat_t"]["Markowitz"]
    aux_j = sj.precompute(world["fd_j"], H)
    aux_t = st.precompute(world["fd_t"], H)
    guess = _guess()[: aux_t["mu"].shape[0]]
    want = np.asarray(sj.rebalance_all(aux_j, jnp.asarray(guess)))
    got = st.rebalance_all(aux_t, _t(guess)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    np.testing.assert_array_equal(got[:4], guess[:4])
    assert np.abs(got[4:] - guess[4:]).max() > 1e-3


def test_dmd_fit_matches(world):
    """The fitted operator's forecasts against kmpc_tpu's: the two
    pseudo-inverses cut singular values at the same relative tolerance.
    The bar is 2e-4 on standardized one-step forecasts of size ~1 (two SVD
    implementations on a 32 x 56 matrix)."""
    fd_j, fd_t = world["fd_j"], world["fd_t"]
    K_j = np.asarray(world["strat_j"]["DMD"].K)
    K_t = T.DMDStrategy(mpc=MPCParams(**MPC_KW)).fit(fd_t.train).K
    assert K_t.shape == K_j.shape == (D * N_ASSETS, D * N_ASSETS)
    x = fd_t.test.numpy()
    np.testing.assert_allclose(x @ K_t.numpy().T, x @ K_j.T, atol=2e-4,
                               rtol=0)
    assert T._pinv_rtol(32, 56) == pytest.approx(
        10 * 56 * np.finfo(np.float32).eps)


def test_dmd_precompute_fits_when_no_operator_is_given(world):
    fd_j, fd_t = world["fd_j"], world["fd_t"]
    strat = T.DMDStrategy(mpc=MPCParams(**MPC_KW))
    aux_t = strat.precompute(fd_t, H)
    assert strat.K is not None
    aux_j = world["strat_j"]["DMD"].precompute(fd_j, H)
    assert aux_t["pred_log_returns"].shape == (fd_t.test.shape[0], H,
                                               N_ASSETS)
    # H applications of the operator, destandardized (std ~ 0.01).
    np.testing.assert_allclose(aux_t["pred_log_returns"].numpy(),
                               np.asarray(aux_j["pred_log_returns"]),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["DMD", "KoopmanMPC"])
def test_log_utility_strategies_precompute_and_rebalance_all_match(world,
                                                                   name):
    sj, st = world["strat_j"][name], world["strat_t"][name]
    aux_j = sj.precompute(world["fd_j"], H)
    aux_t = st.precompute(world["fd_t"], H)
    np.testing.assert_allclose(aux_t["pred_log_returns"].numpy(),
                               np.asarray(aux_j["pred_log_returns"]),
                               atol=1e-5, rtol=0)
    guess = _guess()[: aux_t["pred_log_returns"].shape[0]]
    want = np.asarray(sj.rebalance_all(aux_j, jnp.asarray(guess)))
    got = st.rebalance_all(aux_t, _t(guess)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_scenario_strategy_precompute_law(world):
    """Forecast plus residual_std times paired standard normal draws, the
    same for the same seed."""
    from kmpc_tpu_torch.ops.rollout import predict_returns

    fd_t, tm = world["fd_t"], world["tm"]
    strat = T.ScenarioKoopmanMPCStrategy(
        model=tm, mpc=MPCParams(**MPC_KW), num_scenarios=6, seed=3,
        residual_std=_t(world["rstd"]))
    scen = strat.precompute(fd_t, H)["scenario_log_returns"]
    assert scen.shape == (fd_t.test.shape[0], 6, H, N_ASSETS)
    preds = predict_returns(tm, fd_t.test, H, N_ASSETS, fd_t.mean, fd_t.std)
    eps = (scen - preds[:, None]) / _t(world["rstd"])
    np.testing.assert_allclose(eps[:, 3:].numpy(), -eps[:, :3].numpy(),
                               atol=1e-3)
    assert 0.9 < eps[:, :3].std().item() < 1.1
    again = strat.precompute(fd_t, H)["scenario_log_returns"]
    assert torch.equal(scen, again)
    # Without a given scale the strategy estimates it on the validation
    # split.
    strat.residual_std = None
    est = strat.precompute(fd_t, H)["scenario_log_returns"]
    assert est.shape == scen.shape and torch.isfinite(est).all()


def test_scenario_strategy_rebalance_all_matches(world):
    sj, st = world["strat_j"]["ScenarioKelly"], world["strat_t"]["ScenarioKelly"]
    scen = world["scen"]
    guess = _guess()[: scen.shape[0]]
    want = np.asarray(sj.rebalance_all(
        {"scenario_log_returns": jnp.asarray(scen)}, jnp.asarray(guess)))
    got = st.rebalance_all({"scenario_log_returns": _t(scen)},
                           _t(guess)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("name", ["KoopmanMPC", "ScenarioKelly"])
def test_rebalance_all_warm_matches(world, name):
    """A cold sweep, then a warm one of 100 iterations from numpy copies of
    kmpc_tpu's iterates: targets and carried iterates at the kernel bar."""
    sj, st = world["strat_j"][name], world["strat_t"][name]
    aux_j = sj.precompute(world["fd_j"], H)
    aux_t = st.precompute(world["fd_t"], H)
    n = next(iter(aux_t.values())).shape[0]
    g1, g2 = _guess(1)[:n], _guess(2)[:n]
    tj, (wj, pj) = sj.rebalance_all_warm(aux_j, jnp.asarray(g1), None)
    tt, (wt, pt) = st.rebalance_all_warm(aux_t, _t(g1), None)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=5e-4)
    tj2, (wj2, pj2) = sj.rebalance_all_warm(aux_j, jnp.asarray(g2), (wj, pj),
                                            max_iters=100)
    tt2, (wt2, pt2) = st.rebalance_all_warm(
        aux_t, _t(g2), (_t(wj), _t(pj)), max_iters=100)
    assert wt2.shape == (n, H, N_ASSETS)
    np.testing.assert_allclose(tt2.numpy(), np.asarray(tj2), atol=5e-4)
    np.testing.assert_allclose(wt2.numpy(), np.asarray(wj2), atol=5e-4)
    np.testing.assert_allclose(pt2.numpy(), np.asarray(pj2), atol=5e-4)


def test_eager_and_fused_paths_agree(world):
    """``use_fused_kernel=False`` takes the eager solvers: the same targets
    at the kernel bars."""
    from dataclasses import replace

    for name, tol in (("KoopmanMPC", 5e-4), ("Markowitz", 5e-5),
                      ("ScenarioKelly", 5e-4)):
        st = world["strat_t"][name]
        aux = st.precompute(world["fd_t"], H)
        guess = _t(_guess()[: next(iter(aux.values())).shape[0]])
        fused = st.rebalance_all(aux, guess)
        eager = replace(st, use_fused_kernel=False).rebalance_all(aux, guess)
        np.testing.assert_allclose(eager.numpy(), fused.numpy(), atol=tol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The five-strategy backtest and the warm-sweep backtest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backtests(world):
    bt_j = jcfg.BacktestConfig(HORIZON=H)
    bt_t = tcfg.BacktestConfig(HORIZON=H)
    out = {}
    for name in NAMES:
        out[name] = (
            J.run_backtest_parallel(world["strat_j"][name], world["fd_j"],
                                    bt_j, num_sweeps=SWEEPS),
            T.run_backtest_parallel(world["strat_t"][name], world["fd_t"],
                                    bt_t, num_sweeps=SWEEPS),
        )
    return out


@pytest.mark.parametrize("name,rtol", [
    ("BuyAndHold", 1e-5), ("Markowitz", 1e-4), ("DMD", 1e-3),
    ("KoopmanMPC", 1e-3), ("ScenarioKelly", 1e-3),
])
def test_backtest_matches_per_strategy(backtests, name, rtol):
    dj, dt = backtests[name]
    assert len(dj) == len(dt) == N_DATES
    assert (dj["date"] == dt["date"]).all()
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(),
                               dj["portfolio_value"].to_numpy(), rtol=rtol)
    np.testing.assert_allclose(dt["turnover"].to_numpy(),
                               dj["turnover"].to_numpy(), atol=2e-3)
    assert np.all(np.isfinite(dt[["return", "turnover", "cost"]].to_numpy()))


def test_comparison_table_matches(backtests):
    """The product: one metrics table over the five strategies."""
    table_t = pd.DataFrame({k: T.calculate_metrics(v[1])
                            for k, v in backtests.items()}).T
    table_j = pd.DataFrame({k: J.calculate_metrics(v[0])
                            for k, v in backtests.items()}).T
    assert list(table_t.index) == NAMES
    assert list(table_t.columns) == list(table_j.columns)
    np.testing.assert_allclose(table_t["Final Value"], table_j["Final Value"],
                               rtol=1e-3)
    np.testing.assert_allclose(table_t["Avg Turnover"],
                               table_j["Avg Turnover"], atol=1e-3)
    # The strategies differ: the table is not five copies of one row.
    assert table_t["Final Value"].nunique() == 5


@pytest.mark.parametrize("name", ["KoopmanMPC", "ScenarioKelly"])
def test_warm_sweep_backtest_matches(world, backtests, name):
    """Sweep 1 cold at 300 iterations, sweeps 2-3 warm at 100: the same
    sweeps in both packages (rtol 1e-3, flat faces as above), and close to
    the cold-swept run (2e-2: the warm sweeps are a different, shorter
    solve)."""
    bt_j = jcfg.BacktestConfig(HORIZON=H)
    bt_t = tcfg.BacktestConfig(HORIZON=H)
    dj = J.run_backtest_parallel(world["strat_j"][name], world["fd_j"], bt_j,
                                 num_sweeps=SWEEPS, warm_sweeps_iters=100)
    dt = T.run_backtest_parallel(world["strat_t"][name], world["fd_t"], bt_t,
                                 num_sweeps=SWEEPS, warm_sweeps_iters=100)
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(),
                               dj["portfolio_value"].to_numpy(), rtol=1e-3)
    cold = backtests[name][1]["portfolio_value"].to_numpy()
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(), cold,
                               rtol=2e-2)


def test_warm_sweeps_misuse_raises(world):
    bt = tcfg.BacktestConfig(HORIZON=H)
    with pytest.raises(ValueError, match="rebalance_all_warm"):
        T.make_parallel_backtester(T.BuyAndHoldStrategy(), world["fd_t"], bt,
                                   num_sweeps=4, warm_sweeps_iters=50)
    with pytest.raises(ValueError, match="num_sweeps >= 2"):
        T.make_parallel_backtester(world["strat_t"]["KoopmanMPC"],
                                   world["fd_t"], bt, num_sweeps=1,
                                   warm_sweeps_iters=50)


def test_history_holds_weights_on_the_simplex(world):
    bt = tcfg.BacktestConfig(HORIZON=H)
    for name in ("Markowitz", "ScenarioKelly"):
        hist = T.run_backtest_parallel(world["strat_t"][name], world["fd_t"],
                                       bt, num_sweeps=2,
                                       return_dataframe=False)
        w = hist["weights"].astype(np.float64)
        assert w.shape == (N_DATES, N_ASSETS)
        assert np.all(np.abs(w.sum(-1) - 1.0) <= 1e-5) and np.all(w >= 0)


# ---------------------------------------------------------------------------
# The exact scan path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scans(world):
    """``run_backtest`` of both packages for the five strategies: kmpc_tpu's
    ``lax.scan`` with its XLA solvers, the port's date loop with one fused
    solve (its plain version here) per date."""
    bt_j = jcfg.BacktestConfig(HORIZON=H)
    bt_t = tcfg.BacktestConfig(HORIZON=H)
    return {name: (J.run_backtest(world["strat_j"][name], world["fd_j"], bt_j),
                   T.run_backtest(world["strat_t"][name], world["fd_t"], bt_t))
            for name in NAMES}


@pytest.mark.parametrize("name,rtol", [
    ("BuyAndHold", 1e-5), ("Markowitz", 1e-3), ("DMD", 1e-3),
    ("KoopmanMPC", 1e-3), ("ScenarioKelly", 1e-3),
])
def test_scan_backtest_matches_per_strategy(scans, name, rtol):
    dj, dt = scans[name]
    assert len(dj) == len(dt) == N_DATES
    assert list(dj.columns) == list(dt.columns)
    assert (dj["date"] == dt["date"]).all()
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(),
                               dj["portfolio_value"].to_numpy(), rtol=rtol)
    np.testing.assert_allclose(dt["turnover"].to_numpy(),
                               dj["turnover"].to_numpy(), atol=2e-3)
    assert np.all(np.isfinite(dt[["return", "turnover", "cost"]].to_numpy()))


@pytest.mark.parametrize("name", NAMES)
def test_scan_equals_the_jacobi_path_with_as_many_sweeps_as_dates(
        world, scans, name):
    """Each sweep carries exact pre-trade weights one date further, so
    ``num_sweeps = dates`` is the scan: the same solves on the same
    problems (rtol 1e-5: float32 sums over a batch of 40 and of 1)."""
    bt = tcfg.BacktestConfig(HORIZON=H)
    par = T.run_backtest_parallel(world["strat_t"][name], world["fd_t"], bt,
                                  num_sweeps=N_DATES)
    for col in ("portfolio_value", "turnover"):
        np.testing.assert_allclose(par[col].to_numpy(),
                                   scans[name][1][col].to_numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=col)


def test_scan_history_schema_and_rebalance_freq(world):
    """The raw history: the JAX package's keys, weights on the simplex; with
    REBALANCE_FREQ = 3 every third date, as there."""
    bt_j = jcfg.BacktestConfig(HORIZON=H, REBALANCE_FREQ=3)
    bt_t = tcfg.BacktestConfig(HORIZON=H, REBALANCE_FREQ=3)
    hj = J.run_backtest(world["strat_j"]["Markowitz"], world["fd_j"], bt_j,
                        return_dataframe=False)
    ht = T.run_backtest(world["strat_t"]["Markowitz"], world["fd_t"], bt_t,
                        return_dataframe=False)
    assert set(ht) == set(hj)
    np.testing.assert_array_equal(ht["t"], hj["t"])
    assert len(ht["t"]) == -(-N_DATES // 3)
    np.testing.assert_allclose(ht["portfolio_value"], hj["portfolio_value"],
                               rtol=1e-4)
    w = ht["weights"].astype(np.float64)
    assert w.shape == (len(ht["t"]), N_ASSETS)
    assert np.all(np.abs(w.sum(-1) - 1.0) <= 1e-5) and np.all(w >= 0)


@pytest.mark.parametrize("name", ["KoopmanMPC", "DMD"])
def test_scan_with_per_date_warm_starts_matches(world, name):
    """``use_warm_start``: each date's solve starts from the previous
    date's (primal, dual), through the eager solvers on both sides (the JAX
    ``rebalance`` always takes its XLA solver)."""
    from dataclasses import replace

    bt_j = jcfg.BacktestConfig(HORIZON=H)
    bt_t = tcfg.BacktestConfig(HORIZON=H)
    dj = J.run_backtest(replace(world["strat_j"][name], use_warm_start=True),
                        world["fd_j"], bt_j)
    warm = replace(world["strat_t"][name], use_warm_start=True)
    dt = T.run_backtest(replace(warm, use_fused_kernel=False),
                        world["fd_t"], bt_t)
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(),
                               dj["portfolio_value"].to_numpy(), rtol=1e-3)
    # Through the fused path the warm carry is the kernel's (primal, dual).
    aux = warm.precompute(world["fd_t"], H)
    w0 = torch.full((N_ASSETS,), 1.0 / N_ASSETS)
    carry = (w0.repeat(H, 1), torch.zeros(H, N_ASSETS))
    target, (wp, dual) = warm.rebalance(aux, 3, w0, carry)
    assert target.shape == (N_ASSETS,) and wp.shape == dual.shape == (
        H, N_ASSETS)
    assert torch.equal(target, wp[0])
    cold_target, same = replace(warm, use_warm_start=False).rebalance(
        aux, 3, w0, carry)
    assert same is carry and cold_target.shape == (N_ASSETS,)


def test_buy_and_hold_rebalance_sets_equal_weights_on_the_first_date_only():
    w = torch.tensor([0.5, 0.3, 0.2])
    strat = T.BuyAndHoldStrategy()
    first, _ = strat.rebalance({}, 0, w, None)
    later, _ = strat.rebalance({}, 4, w, None)
    assert torch.allclose(first, torch.full((3,), 1.0 / 3))
    assert torch.equal(later, w)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eager", [False, True])
def test_run_experiment_cli_runs_all_five_strategies(tmp_path, monkeypatch,
                                                     eager, capsys):
    """The port's CLI on the CPU at a tiny budget, full-width
    finance_sparse with fresh weights: a five-row table, nothing skipped."""
    import json

    from kmpc_tpu_torch.run_experiment import main

    monkeypatch.chdir(tmp_path)
    argv = ["--cpu", "--mpc_iters", "10", "--parallel", "--sweeps", "1",
            "--scenarios", "3",
            "--risk_aversion", "2.0", "--output", str(tmp_path / "out")]
    results = main(argv + (["--eager"] if eager else []))
    assert list(results) == NAMES
    for metrics in results.values():
        assert np.isfinite(metrics["Final Value"])
    out = capsys.readouterr().out
    assert "skipped" not in out and "Not ported" not in out
    for name in NAMES:
        assert f"Backtesting {name}" in out
    saved = json.loads((tmp_path / "out" / "experiment_results.json")
                       .read_text())
    assert saved == results
    table = pd.read_csv(tmp_path / "out" / "full_comparison_metrics.csv",
                        index_col=0)
    assert list(table.index) == NAMES


def test_run_experiment_cli_scan_and_exact_sweeps(tmp_path, monkeypatch,
                                                  capsys):
    """With no mode flag the CLI walks the dates (the exact scan, as
    kmpc_tpu's); ``--parallel --sweeps 0`` is as many sweeps as dates. A
    test split cut to a few dates keeps both small; both give the same
    table (the Jacobi path is then exact)."""
    import kmpc_tpu_torch.data.finance as F
    from kmpc_tpu_torch.run_experiment import main

    load = F.load_finance_data

    def short(cfg, **kw):
        fd = load(cfg, **kw)
        n = 6 + fd.sequence_length + cfg.MPC.HORIZON
        fd.test, fd.test_dates = fd.test[:n], fd.test_dates[:n]
        return fd

    monkeypatch.setattr(F, "load_finance_data", short)
    monkeypatch.chdir(tmp_path)
    argv = ["--cpu", "--mpc_iters", "15", "--scenarios", "2",
            "--output", str(tmp_path / "out")]
    scan = main(argv)
    out = capsys.readouterr().out
    assert "date scan on cpu" in out and "sweeps on" not in out
    exact = main(argv + ["--parallel", "--sweeps", "0"])
    assert "(6 sweeps on cpu)" in capsys.readouterr().out
    assert list(scan) == list(exact) == NAMES
    for name in NAMES:
        assert scan[name]["Final Value"] == pytest.approx(
            exact[name]["Final Value"], rel=1e-5)


def test_cli_settings_match_the_jax_cli():
    """``mv_mpc`` as the JAX CLI builds it: horizon 1, gamma the risk
    aversion, the config's sigma_scale (1), no turnover override."""
    from kmpc_tpu.ops.mpc import mpc_params_from_config as jfrom
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, markowitz_settings,
    )

    cfg_t = tcfg.get_config("finance_sparse")
    cfg_j = jcfg.get_config("finance_sparse")
    mv = markowitz_settings(cfg_t, risk_aversion=2.5, cost_coeff=0.002,
                            mpc_iters=77)
    want = jfrom(cfg_j, horizon=1, gamma=2.5, cost_coeff=0.002, max_iters=77)
    assert vars(mv) == vars(want)
    _, mpc = backtest_settings(cfg_t)
    assert mpc.sigma_scale == 2.0 and mv.sigma_scale == 1.0


# ---------------------------------------------------------------------------
# Warm Jacobi sweeps at full width, both packages
# ---------------------------------------------------------------------------


def full_width_warm_and_cold_final_values(sweeps=8, warm_iters=500):
    """Final portfolio values of the Koopman-MPC Jacobi backtest at full
    width (finance_sparse, seed-0 kmpc_tpu weights carried into the port,
    the synthetic panel, 1028 dates, H=5, N=20, the experiment's MPCParams),
    cold sweeps and warm sweeps, through kmpc_tpu's XLA solver and the
    port's eager solver: {"jax_cold", "jax_warm", "torch_cold",
    "torch_warm"}."""
    from kmpc_tpu.data.finance import load_finance_data as jload
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu_torch.data.finance import load_finance_data as tload
    from kmpc_tpu_torch.models.koopman import make_model as tmake
    from kmpc_tpu_torch.run_experiment import backtest_settings
    from kmpc_tpu_torch.utils.params import params_from_jax

    cfg_j, cfg_t = (m.get_config("finance_sparse") for m in (jcfg, tcfg))
    cfg_j.ENV.FINANCE.CACHE_DIR = cfg_t.ENV.FINANCE.CACHE_DIR = None
    fd_j, fd_t = jload(cfg_j), tload(cfg_t, device="cpu")
    jm = jmake(cfg_j, fd_j.observation_size)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tmake(cfg_t, fd_t.observation_size, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tm.eval()
    bt_t, mpc_t = backtest_settings(cfg_t)
    bt_j = jcfg.BacktestConfig(**vars(bt_t))
    mpc_j = JParams(**vars(mpc_t))
    sj = J.KoopmanMPCStrategy(model=jm, params=params, mpc=mpc_j)
    st = T.KoopmanMPCStrategy(model=tm, mpc=mpc_t, use_fused_kernel=False)
    out = {}
    for key, warm in (("cold", None), ("warm", warm_iters)):
        dj = J.run_backtest_parallel(sj, fd_j, bt_j, num_sweeps=sweeps,
                                     warm_sweeps_iters=warm)
        dt = T.run_backtest_parallel(st, fd_t, bt_t, num_sweeps=sweeps,
                                     warm_sweeps_iters=warm)
        assert len(dj) == len(dt) == 1028
        out[f"jax_{key}"] = float(dj["portfolio_value"].iloc[-1])
        out[f"torch_{key}"] = float(dt["portfolio_value"].iloc[-1])
    return out


@pytest.mark.slow
def test_full_width_warm_sweeps_match_the_reference():
    """At full width 8 Jacobi sweeps are not converged on random-weight
    forecasts, so warm sweeps end percents away from cold ones: in kmpc_tpu
    as in the port. The port must reproduce kmpc_tpu's final values, cold
    and warm, within 1e-3 relative."""
    v = full_width_warm_and_cold_final_values()
    print(v)
    for key in ("cold", "warm"):
        assert abs(v[f"torch_{key}"] / v[f"jax_{key}"] - 1.0) <= 1e-3, v
    gap_j = abs(v["jax_warm"] / v["jax_cold"] - 1.0)
    gap_t = abs(v["torch_warm"] / v["torch_cold"] - 1.0)
    assert abs(gap_t - gap_j) <= 2e-3, v
