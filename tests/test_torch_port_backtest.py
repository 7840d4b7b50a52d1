"""kmpc_tpu_torch's forecast and Jacobi backtest against kmpc_tpu's.

A small synthetic panel built as bench.py's backtest benchmark builds it
(here 48 rebalance dates, 8 assets, embedding 4) and a narrow GenericKM
(z 16, encoder [32]) whose kmpc_tpu weights are carried into the port. The
JAX side runs its fused kernel in interpret mode on the CPU.

Bars: buy-and-hold rtol 1e-5 (the same float32 recursion); Koopman-MPC
portfolio value rtol 1e-3 (weights may move along near-flat faces of the
MPC program, which moves the costs slightly); the forecast atol 1e-5
(float32 matmuls summed in another order).
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

N_ASSETS, D, N_DATES, H = 8, 4, 48, 5
MPC_KW = dict(max_iters=300, sigma_scale=2.0)
SWEEPS = 3


def _panel():
    rng = np.random.default_rng(0)
    n_rows = N_DATES + 1 + H + D - 1
    rets = (rng.standard_normal((n_rows, N_ASSETS)) * 0.01).astype(np.float32)
    mean = rets.mean(0)
    std = np.maximum(rets.std(0), 1e-8)
    return rets, mean, std


def _finance_data(pkg):
    """bench.py's synthetic FinanceData, in kmpc_tpu ('jax') or
    kmpc_tpu_torch ('torch') form."""
    if pkg == "jax":
        from kmpc_tpu.data.finance import (
            FinanceData, FinanceStats, time_delay_embedding,
        )
        arr = jnp.asarray
    else:
        from kmpc_tpu_torch.data.finance import (
            FinanceData, FinanceStats, time_delay_embedding,
        )

        def arr(a):
            return torch.as_tensor(np.asarray(a, np.float32))

    rets, mean, std = _panel()
    emb = time_delay_embedding((rets - mean) / std, D)
    dates = pd.bdate_range("2005-01-03", periods=len(emb))
    stats = FinanceStats(mean=mean, std=std,
                         tickers=[f"A{i}" for i in range(N_ASSETS)])
    meta = {"n_assets": N_ASSETS, "embedding_dim": D,
            "observation_size": D * N_ASSETS}
    third = len(emb) // 3
    return FinanceData(
        train=arr(emb[:third]), val=arr(emb[third:2 * third]), test=arr(emb),
        train_dates=dates[:third], val_dates=dates[third:2 * third],
        test_dates=dates, stats=stats, metadata=meta, mean=arr(mean),
        std=arr(std), sequence_length=1,
    )


def build_models():
    """The narrow GenericKM in both packages, kmpc_tpu's weights carried
    into the port: (kmpc_tpu model, its params, port model)."""
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
    # A slightly contracting, non-identity K: forecasts that differ by date.
    rng = np.random.default_rng(7)
    params["kmat"] = (0.9 * np.eye(16) + 0.05 * rng.standard_normal((16, 16))
                      ).astype(np.float32)
    tm = tmake(cfgs[1], D * N_ASSETS, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def backtests(models):
    """Both packages' Jacobi backtests, Koopman-MPC and buy-and-hold."""
    jm, params, tm = models
    bt_j = jcfg.BacktestConfig(HORIZON=H)
    bt_t = tcfg.BacktestConfig(HORIZON=H)
    fd_j, fd_t = _finance_data("jax"), _finance_data("torch")
    out = {}
    out["kmpc"] = (
        J.run_backtest_parallel(
            J.KoopmanMPCStrategy(model=jm, params=params,
                                 mpc=JParams(**MPC_KW),
                                 use_fused_kernel=True),
            fd_j, bt_j, num_sweeps=SWEEPS),
        T.run_backtest_parallel(
            T.KoopmanMPCStrategy(model=tm, mpc=MPCParams(**MPC_KW)),
            fd_t, bt_t, num_sweeps=SWEEPS),
    )
    out["bh"] = (
        J.run_backtest_parallel(J.BuyAndHoldStrategy(), fd_j, bt_j,
                                num_sweeps=SWEEPS),
        T.run_backtest_parallel(T.BuyAndHoldStrategy(), fd_t, bt_t,
                                num_sweeps=SWEEPS),
    )
    return out


def test_predict_returns_matches(models):
    from kmpc_tpu.ops.rollout import predict_returns as jpred
    from kmpc_tpu_torch.ops.rollout import predict_returns as tpred

    jm, params, tm = models
    fd_j, fd_t = _finance_data("jax"), _finance_data("torch")
    want = np.asarray(jpred(jm, params, fd_j.test, H, N_ASSETS, fd_j.mean,
                            fd_j.std))
    got = tpred(tm, fd_t.test, H, N_ASSETS, fd_t.mean, fd_t.std)
    assert got.shape == (fd_t.test.shape[0], H, N_ASSETS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("reencode_period", [0, 1, 2])
def test_rollout_matches(models, reencode_period):
    from kmpc_tpu.ops.rollout import rollout as jroll
    from kmpc_tpu_torch.ops.rollout import rollout as troll

    jm, params, tm = models
    x0 = np.random.default_rng(1).standard_normal((6, D * N_ASSETS)).astype(
        np.float32)
    want = np.asarray(jroll(jm, params, jnp.asarray(x0), 4, reencode_period))
    got = troll(tm, torch.as_tensor(x0), 4, reencode_period)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_history_frames_have_the_same_dates(backtests):
    for key in ("kmpc", "bh"):
        dj, dt = backtests[key]
        assert len(dj) == len(dt) == N_DATES
        assert list(dj.columns) == list(dt.columns)
        assert (dj["date"] == dt["date"]).all()


def test_buy_and_hold_matches(backtests):
    dj, dt = backtests["bh"]
    for col in ("portfolio_value", "return", "turnover", "cost"):
        np.testing.assert_allclose(dt[col].to_numpy(), dj[col].to_numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=col)


def test_koopman_mpc_matches(backtests):
    dj, dt = backtests["kmpc"]
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(),
                               dj["portfolio_value"].to_numpy(), rtol=1e-3)
    assert np.all(np.isfinite(dt[["return", "turnover", "cost"]].to_numpy()))
    # The strategy trades: the MPC moves weights on some dates.
    assert dt["turnover"].to_numpy()[1:].max() > 1e-4


@pytest.mark.parametrize("key", ["kmpc", "bh"])
def test_calculate_metrics_identical_on_identical_frames(backtests, key):
    dj, dt = backtests[key]
    for df in (dj, dt):
        assert T.calculate_metrics(df) == J.calculate_metrics(df)
    assert T.calculate_metrics(dt.iloc[:0]) == J.calculate_metrics(
        dj.iloc[:0]) == {}


@pytest.mark.parametrize("realized", [np.log1p(0.01), np.log1p(-0.3),
                                      -np.inf])
def test_market_step_matches(realized):
    """Cost, growth and drift for every asset returning the same amount,
    down to a total loss (exp(-inf) - 1 = -1)."""
    rng = np.random.default_rng(3)
    cur = rng.dirichlet(np.ones(N_ASSETS)).astype(np.float32)
    tgt = rng.dirichlet(np.ones(N_ASSETS)).astype(np.float32)
    real = np.full(N_ASSETS, realized, np.float32)
    gross = torch.exp(torch.as_tensor(real)) - 1.0
    for has_next in (True, False):
        want = J._market_step(jnp.float32(1000.0), jnp.asarray(cur),
                              jnp.asarray(tgt), jnp.asarray(real),
                              jnp.asarray(has_next), 0.001)
        got = T._market_step(torch.tensor(1000.0), torch.as_tensor(cur),
                             torch.as_tensor(tgt), gross, has_next, 0.001)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("denom,guarded", [(0.0, 1e-8), (-5e-9, -1e-8),
                                           (5e-9, 1e-8), (-0.5, -0.5)])
def test_market_step_guard_keeps_the_denominators_sign(denom, guarded):
    """1 + r_p is replaced by +-1e-8 only when it is smaller than that, and
    keeps its sign: a ruin day must not flip the drifted weights."""
    tgt = torch.zeros(3, dtype=torch.float64)
    tgt[0] = 1.0
    gross = torch.tensor([denom - 1.0, 0.5, 0.5], dtype=torch.float64)
    _, drifted, port_ret, _, _ = T._market_step(
        torch.tensor(1.0, dtype=torch.float64), tgt, tgt, gross, True, 0.0)
    assert port_ret.item() == pytest.approx(denom - 1.0, abs=1e-15)
    assert drifted[0].item() == pytest.approx(denom / guarded, rel=1e-6)


@pytest.mark.parametrize("from_run_dir", [False, True])
def test_run_experiment_cli_on_the_cpu(tmp_path, monkeypatch, from_run_dir):
    """The port's CLI end to end at a tiny budget: fresh full-width
    finance_sparse weights, or a narrow kmpc_tpu run directory."""
    import json

    from kmpc_tpu_torch.run_experiment import main

    monkeypatch.chdir(tmp_path)
    argv = ["--cpu", "--mpc_iters", "20", "--parallel", "--sweeps", "1",
            "--output", str(tmp_path / "out")]
    if from_run_dir:
        from kmpc_tpu.models import make_model as jmake
        from kmpc_tpu.train.loop import init_train_state
        from kmpc_tpu.utils.checkpoint import save_checkpoint

        cfg = jcfg.get_config("finance_sparse")
        cfg.MODEL.TARGET_SIZE = 16
        cfg.MODEL.ENCODER.LAYERS = [32]
        cfg.ENV.FINANCE.CACHE_DIR = None
        run = tmp_path / "run"
        run.mkdir()
        cfg.to_json(str(run / "config.json"))
        state = init_train_state(cfg, jmake(cfg, 400), jax.random.PRNGKey(2))
        save_checkpoint(run / "checkpoint", state, 5, cfg.to_dict())
        argv += ["--path", str(run)]
    results = main(argv)
    assert list(results) == ["BuyAndHold", "Markowitz", "DMD", "KoopmanMPC"]
    for metrics in results.values():
        assert np.isfinite(metrics["Final Value"])
    saved = json.loads((tmp_path / "out" / "experiment_results.json")
                       .read_text())
    assert saved == results
    assert (tmp_path / "out" / "full_comparison_metrics.csv").exists()


@pytest.mark.parametrize("argv", [[], ["--parallel"], ["--parallel", "--sweeps", "0"],
                                  ["--parallel", "--sweeps", "3"], ["--sweeps", "2"]])
def test_cli_default_mode_matches_the_jax_cli(argv, monkeypatch):
    """Both CLIs' flags parsed, neither run: with no flag the exact scan
    over dates, with ``--parallel`` the Jacobi backtest, ``--sweeps`` 0 (as
    many as dates, exact) unless given; the same mode and sweep count."""
    import argparse
    import importlib.util
    import sys
    from pathlib import Path

    from kmpc_tpu_torch.run_experiment import backtest_mode, parse_args

    path = Path(__file__).resolve().parent.parent / "run_experiment.py"
    spec = importlib.util.spec_from_file_location("jax_run_experiment", path)
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)

    class Parsed(Exception):
        pass

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["args"] = parse(self, args, namespace)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", ["run_experiment.py", *argv])
    with pytest.raises(Parsed):
        root.main()
    monkeypatch.undo()
    jargs = seen["args"]
    jax_mode = ("parallel" if jargs.parallel else "scan", jargs.sweeps)
    assert backtest_mode(parse_args(argv)) == jax_mode
    assert backtest_mode(parse_args([]))[0] == "scan"
