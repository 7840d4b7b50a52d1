"""kmpc_tpu_torch's eager solvers and projections against kmpc_tpu's.

Same numpy-seeded inputs through the JAX function and its PyTorch
counterpart, float32 on the CPU. The two run the same iteration operation
for operation, so they differ by summation order only: weights, duals and
objectives are held to 2e-5 / 5e-6 after 300 iterations (measured about
1e-6), projections to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmpc_tpu.ops import mpc as JM
from kmpc_tpu.ops import projections as JPROJ
from kmpc_tpu.ops import scenario as JS
from kmpc_tpu_torch.ops import mpc as TM
from kmpc_tpu_torch.ops import projections as TPROJ
from kmpc_tpu_torch.ops import scenario as TS

W_TOL = 2e-5
OBJ_TOL = 5e-6
B, S, H, N = 5, 4, 5, 12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01 + 0.0005).astype(np.float32)
    scen = (rng.standard_normal((B, S, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((B, N, N)) * 0.05
    sig = (np.einsum("bij,bkj->bik", A, A) + np.eye(N) * 1e-4).astype(
        np.float32)
    return cw, ys, scen, sig


def _both(kw):
    kw = {"max_iters": 300, "sigma_scale": 2.0, **kw}
    return JM.MPCParams(**kw), TM.MPCParams(**kw)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0, err_msg=what)


def _check_info(it, ij, keys):
    assert set(it) == set(ij)
    for k in keys:
        _close(it[k], ij[k], W_TOL if k != "objective" else OBJ_TOL, k)
    for k in ("converged", "status_code"):
        assert np.array_equal(it[k].numpy(), np.asarray(ij[k])), k


SURFACE = {
    "default": {},
    "allow_short": dict(allow_short=True),
    "adaptive_every_1": dict(adaptive=True),
    "adaptive_every_2_precond": dict(adaptive=True, adapt_every=2,
                                     precond=True),
    "over_relax": dict(over_relax=1.5),
    "cold_projections": dict(proj_warm_iters=0),
    "no_ball_ridge": dict(max_turnover=0.0, ridge=1e-3),
}


@pytest.mark.parametrize("name", list(SURFACE))
def test_log_utility_batch_matches(name):
    cw, ys, _, _ = _inputs(1)
    pj, pt = _both(SURFACE[name])
    wj, ij = JM.solve_mpc_log_utility_batch(jnp.asarray(cw), jnp.asarray(ys),
                                            pj)
    wt, it = TM.solve_mpc_log_utility_batch(_t(cw), _t(ys), pt)
    assert wt.shape == (B, H, N) and wt.dtype == torch.float32
    _close(wt, wj, W_TOL, "weights")
    _check_info(it, ij, ("objective", "dual", "fixed_point_residual",
                         "turnover_violation"))
    if name == "allow_short":
        # The hyperplane projection is exercised: shorts do occur.
        assert wt.min().item() < -1e-6


def test_log_utility_batch_warm_start_matches():
    """A 100-iteration continuation from a 300-iteration solve's (primal,
    dual), on both sides from the same numpy iterates."""
    cw, ys, _, _ = _inputs(2)
    pj, pt = _both({})
    w0, i0 = JM.solve_mpc_log_utility_batch(jnp.asarray(cw), jnp.asarray(ys),
                                            pj)
    w0, p0 = np.asarray(w0), np.asarray(i0["dual"])
    pj, pt = _both(dict(max_iters=100))
    wj, ij = JM.solve_mpc_log_utility_batch(
        jnp.asarray(cw), jnp.asarray(ys), pj, w_warm=jnp.asarray(w0),
        p_warm=jnp.asarray(p0))
    wt, it = TM.solve_mpc_log_utility_batch(_t(cw), _t(ys), pt,
                                            w_warm=_t(w0), p_warm=_t(p0))
    _close(wt, wj, W_TOL)
    _check_info(it, ij, ("objective", "dual"))


def test_log_utility_batch_broadcasts_over_leading_axes():
    cw, ys, _, _ = _inputs(3)
    _, pt = _both(dict(max_iters=50))
    w_flat, _ = TM.solve_mpc_log_utility_batch(_t(cw), _t(ys), pt)
    w_one, info = TM.solve_mpc_log_utility_batch(_t(cw[2]), _t(ys[2]), pt)
    assert w_one.shape == (H, N) and info["objective"].shape == ()
    _close(w_one, w_flat[2].numpy(), 1e-6)


@pytest.mark.parametrize("name", ["default", "allow_short",
                                  "adaptive_every_2_precond", "precond"])
def test_scenarios_matches(name):
    cw, _, scen, _ = _inputs(4)
    kw = dict(precond=True) if name == "precond" else SURFACE[name]
    pj, pt = _both(kw)
    wj, ij = JS.solve_mpc_log_utility_scenarios(jnp.asarray(cw),
                                                jnp.asarray(scen), pj)
    wt, it = TS.solve_mpc_log_utility_scenarios(_t(cw), _t(scen), pt)
    _close(wt, wj, W_TOL)
    assert it.pop("num_scenarios") == ij.pop("num_scenarios") == S
    _check_info(it, ij, ("objective", "dual", "fixed_point_residual"))


def test_scenarios_warm_start_matches():
    cw, _, scen, _ = _inputs(5)
    rng = np.random.default_rng(5)
    w0 = rng.dirichlet(np.ones(N), size=(B, H)).astype(np.float32)
    p0 = (rng.standard_normal((B, H, N)) * 1e-3).astype(np.float32)
    pj, pt = _both(dict(max_iters=150))
    wj, ij = JS.solve_mpc_log_utility_scenarios(
        jnp.asarray(cw), jnp.asarray(scen), pj, w_warm=jnp.asarray(w0),
        p_warm=jnp.asarray(p0))
    wt, it = TS.solve_mpc_log_utility_scenarios(_t(cw), _t(scen), pt,
                                                w_warm=_t(w0), p_warm=_t(p0))
    _close(wt, wj, W_TOL)
    _close(it["dual"], ij["dual"], W_TOL)


@pytest.mark.parametrize("name", ["default", "allow_short",
                                  "adaptive_every_1", "over_relax"])
@pytest.mark.parametrize("batched_sigma", [True, False])
def test_mean_variance_batch_matches(name, batched_sigma):
    cw, ys, _, sig = _inputs(6)
    sig = sig if batched_sigma else sig[0]
    pj, pt = _both(dict(gamma=5.0, **SURFACE[name]))
    wj, ij = JM.solve_mpc_mean_variance_batch(
        jnp.asarray(cw), jnp.asarray(ys), jnp.asarray(sig), pj)
    wt, it = TM.solve_mpc_mean_variance_batch(_t(cw), _t(ys), _t(sig), pt)
    _close(wt, wj, 5e-6)
    _check_info(it, ij, ("objective", "fixed_point_residual"))


def test_reference_signature_wrappers_match():
    cw, ys, _, sig = _inputs(7)
    pj, pt = _both({})
    wj, ij = JM.solve_mpc_log_utility(cw[0], ys[0], pj)
    wt, it = TM.solve_mpc_log_utility(cw[0], ys[0], pt, device="cpu")
    assert isinstance(wt, np.ndarray) and wt.shape == (H, N)
    np.testing.assert_allclose(wt, wj, atol=W_TOL, rtol=0)
    assert it["status"] == ij["status"]
    assert it["value"] == pytest.approx(ij["value"], abs=OBJ_TOL)
    assert it["turnover_violation"] == pytest.approx(
        ij["turnover_violation"], abs=W_TOL)
    pj, pt = _both(dict(gamma=5.0))
    wj, ij = JM.solve_mpc_mean_variance(cw[0], ys[0], sig[0], pj)
    wt, it = TM.solve_mpc_mean_variance(cw[0], ys[0], sig[0], pt,
                                        device="cpu")
    np.testing.assert_allclose(wt, wj, atol=5e-6, rtol=0)
    assert set(it) == set(ij) == {"status", "value"}
    assert it["value"] == pytest.approx(ij["value"], abs=OBJ_TOL)


@pytest.mark.parametrize("solver", ["log", "scenarios", "mean_variance",
                                    "log_single"])
def test_eager_solvers_refuse_polish(solver):
    """The batch solvers refuse ``polish`` and name the entries that run
    it; the single-problem solver runs it (ops/mpc_polish.py), as
    kmpc_tpu's does."""
    cw, ys, scen, sig = _inputs(8)
    p = TM.MPCParams(max_iters=5, polish=True)
    if solver == "log_single":
        p = TM.MPCParams(max_iters=3000, sigma_scale=2.0, ridge=1e-3,
                         polish=True)
        w, info = TM.solve_mpc_log_utility(cw[0], ys[0], p, device="cpu")
        assert w.dtype == np.float64 and w.shape == ys[0].shape
        assert info["polish_residual_after"] < 1e-10
        return
    with pytest.raises(ValueError,
                       match="solve_mpc_log_utility_batch_polished"):
        if solver == "log":
            TM.solve_mpc_log_utility_batch(_t(cw), _t(ys), p)
        elif solver == "scenarios":
            TS.solve_mpc_log_utility_scenarios(_t(cw), _t(scen), p)
        else:
            TM.solve_mpc_mean_variance_batch(_t(cw), _t(ys), _t(sig), p)


def test_balance_steps_matches():
    rng = np.random.default_rng(9)
    pr, dr = (rng.uniform(0.1, 3.0, size=(2, 7, 1, 1)).astype(np.float32))
    tau, sig = (rng.uniform(0.01, 1.0, size=(2, 7, 1, 1)).astype(np.float32))
    alpha = np.full((7, 1, 1), 0.5, np.float32)
    want = JM._balance_steps(*(jnp.asarray(a) for a in (pr, dr, tau, sig,
                                                        alpha)))
    got = TM._balance_steps(*(_t(a) for a in (pr, dr, tau, sig, alpha)))
    for g, w in zip(got, want):
        _close(g, w, 1e-7)


@pytest.mark.parametrize("adapt_every,i,adapts", [(1, 0, True), (2, 0, False),
                                                  (2, 1, True), (3, 4, False),
                                                  (3, 5, True)])
def test_adaptive_update_schedule(adapt_every, i, adapts):
    """The residuals are taken on the last iteration of each k-block, and
    then equal kmpc_tpu's update."""
    rng = np.random.default_rng(10)
    w, w_new = rng.dirichlet(np.ones(N), size=(2, B, H)).astype(np.float32)
    p, p_new = (rng.standard_normal((2, B, H, N)) * 1e-2).astype(np.float32)
    tau = np.full((B, 1, 1), 0.05, np.float32)
    sig = np.full((B, 1, 1), 3.0, np.float32)
    alpha = np.full((B, 1, 1), 0.5, np.float32)
    args = (w, w_new, p, p_new, tau, sig, alpha)
    got = TM._adaptive_update(i, TM.MPCParams(adaptive=True,
                                              adapt_every=adapt_every),
                              *(_t(a) for a in args))
    want = JM._adaptive_update(jnp.int32(i),
                               JM.MPCParams(adaptive=True,
                                            adapt_every=adapt_every),
                               *(jnp.asarray(a) for a in args))
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-6)
    assert (not np.array_equal(got[0].numpy(), tau)) is adapts


# ---------------------------------------------------------------------------
# Projections, each against its kmpc_tpu twin
# ---------------------------------------------------------------------------


def _vectors(n, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((4, 3, n))
            * scale).astype(np.float32)


@pytest.mark.parametrize("n", [3, 20, 33, 300])
@pytest.mark.parametrize("radius", [1.0, 0.2])
def test_project_simplex_matches(n, radius):
    v = _vectors(n, n)
    got = TPROJ.project_simplex(_t(v), radius)
    _close(got, JPROJ.project_simplex(jnp.asarray(v), radius), 1e-6)
    assert np.allclose(got.double().sum(-1).numpy(), radius, atol=1e-6)


def test_project_simplex_exact_sum_far_from_the_radius():
    """|v| >> radius with ties: the last correction keeps the sum exact."""
    v = np.full((2, 50), 1000.0, np.float32)
    v[1, ::2] += 0.25
    got = TPROJ.project_simplex(_t(v))
    _close(got, JPROJ.project_simplex(jnp.asarray(v)), 1e-6)
    assert np.allclose(got.double().sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n", [5, 33])
def test_project_simplex_warm_matches(n):
    v = _vectors(n, n + 1)
    th0 = _vectors(1, n + 2, 0.05)
    w_j, th_j = JPROJ.project_simplex_warm(jnp.asarray(v), 1.0,
                                           jnp.asarray(th0), 3)
    w_t, th_t = TPROJ.project_simplex_warm(_t(v), 1.0, _t(th0), 3)
    _close(w_t, w_j, 1e-6)
    _close(th_t, th_j, 1e-6)


@pytest.mark.parametrize("n", [5, 33])
@pytest.mark.parametrize("radius", [0.2, 5.0])
def test_prox_l1_in_ball_warm_matches(n, radius):
    """A small radius (outside the ball: projected) and a large one
    (inside: the soft threshold alone)."""
    v = _vectors(n, n + 3)
    th0 = np.zeros((4, 3, 1), np.float32)
    u_j, th_j = JPROJ.prox_l1_in_ball_warm(jnp.asarray(v), 0.01, radius,
                                           jnp.asarray(th0), 3)
    u_t, th_t = TPROJ.prox_l1_in_ball_warm(_t(v), 0.01, radius, _t(th0), 3)
    _close(u_t, u_j, 1e-6)
    _close(th_t, th_j, 1e-6)


@pytest.mark.parametrize("threshold", [0.0, 0.1, 10.0])
def test_soft_threshold_matches(threshold):
    v = _vectors(9, 11)
    _close(TPROJ.soft_threshold(_t(v), threshold),
           JPROJ.soft_threshold(jnp.asarray(v), threshold), 0)


@pytest.mark.parametrize("radius", [0.0, 0.2, 1.0, 50.0])
def test_project_l1_ball_matches(radius):
    v = _vectors(20, 12)
    got = TPROJ.project_l1_ball(_t(v), radius)
    _close(got, JPROJ.project_l1_ball(jnp.asarray(v), radius), 1e-6)
    assert (got.double().abs().sum(-1) <= radius + 1e-6).all()


@pytest.mark.parametrize("radius", [0.2, 50.0])
def test_prox_l1_in_ball_matches(radius):
    v = _vectors(20, 13)
    _close(TPROJ.prox_l1_in_ball(_t(v), 0.05, radius),
           JPROJ.prox_l1_in_ball(jnp.asarray(v), 0.05, radius), 1e-6)


def test_project_box_and_hyperplane_match():
    v = _vectors(7, 14)
    _close(TPROJ.project_box(_t(v), -0.1, 0.2),
           JPROJ.project_box(jnp.asarray(v), -0.1, 0.2), 0)
    got = TPROJ.project_hyperplane_sum(_t(v), 1.0)
    _close(got, JPROJ.project_hyperplane_sum(jnp.asarray(v), 1.0), 1e-6)
    assert np.allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# Scenario generation: the random streams differ, so the law is tested
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_scenarios", [8, 7])
def test_generate_return_scenarios_pairing_and_scale(num_scenarios):
    rng = np.random.default_rng(15)
    point = _t((rng.standard_normal((6, H, N)) * 0.01).astype(np.float32))
    rstd = _t(rng.uniform(0.005, 0.02, size=(H, N)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    scen = TS.generate_return_scenarios(point, rstd, num_scenarios, gen)
    assert scen.shape == (6, num_scenarios, H, N)
    eps = (scen - point[:, None]) / rstd
    half = (num_scenarios + 1) // 2
    # Scenario s + half mirrors scenario s; an odd count drops one mirror.
    mirrored = num_scenarios - half
    np.testing.assert_allclose(eps[:, half:].numpy(),
                               -eps[:, :mirrored].numpy(), atol=1e-4)
    again = TS.generate_return_scenarios(
        point, rstd, num_scenarios, torch.Generator().manual_seed(3))
    assert torch.equal(scen, again)


def test_generate_return_scenarios_law():
    """Standard normal draws scaled by residual_std around the forecast:
    mean and std over 4096 unpaired scenarios within 5 standard errors."""
    point = torch.full((1, 2, 3), 0.01)
    rstd = torch.tensor([[0.01, 0.02, 0.03], [0.02, 0.01, 0.005]])
    n = 4096
    scen = TS.generate_return_scenarios(
        point, rstd, n, torch.Generator().manual_seed(0), antithetic=False)
    dev = scen[0] - point
    assert (dev.mean(0).abs() <= 5 * rstd / np.sqrt(n)).all()
    assert ((dev.std(0) / rstd - 1).abs() <= 5 / np.sqrt(2 * n)).all()
    paired = TS.generate_return_scenarios(
        point, rstd, 64, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(paired.mean(1).numpy(), point.numpy(),
                               atol=1e-7)


def test_estimate_residual_std_matches():
    """Population std of the forecast residuals, on a narrow model whose
    kmpc_tpu weights are carried into the port."""
    import kmpc_tpu.config as jcfg
    import kmpc_tpu_torch.config as tcfg
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu_torch.models.koopman import make_model as tmake
    from kmpc_tpu_torch.utils.params import params_from_jax

    n_assets, d = 4, 3
    cfgs = []
    for cfgmod in (jcfg, tcfg):
        cfg = cfgmod.get_config("generic")
        cfg.MODEL.TARGET_SIZE = 8
        cfg.MODEL.ENCODER.LAYERS = [16]
        cfgs.append(cfg)
    jm = jmake(cfgs[0], n_assets * d)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tmake(cfgs[1], n_assets * d, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(16)
    val = rng.standard_normal((40, n_assets * d)).astype(np.float32)
    mean = rng.standard_normal(n_assets).astype(np.float32) * 0.001
    std = rng.uniform(0.005, 0.02, n_assets).astype(np.float32)
    want = JS.estimate_residual_std(jm, params, jnp.asarray(val), 3, n_assets,
                                    jnp.asarray(mean), jnp.asarray(std),
                                    max_windows=16)
    got = TS.estimate_residual_std(tm.eval(), _t(val), 3, n_assets, _t(mean),
                                   _t(std), max_windows=16)
    assert got.shape == (3, n_assets)
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="horizon"):
        TS.estimate_residual_std(tm, _t(val[:3]), 3, n_assets, _t(mean),
                                 _t(std))
