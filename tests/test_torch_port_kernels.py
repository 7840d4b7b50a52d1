"""The plain PyTorch versions of kmpc_tpu_torch's CUDA kernels against
kmpc_tpu's Pallas kernels: the log-utility kernel with warm inputs and the
dual output, the scenario kernel, the mean-variance kernel, and the
residual-balancing adaptive body of all three.

The JAX reference is the Pallas wrapper in interpret mode on the CPU, as
tests/test_mpc_pallas.py runs it; the port runs each kernel's plain version
through its CPU entry point (on the CPU a wrapper takes the plain version
only because the tensor lies there). Every interpret-mode reference is
computed once per module.

Bars (the repository's kernel-vs-XLA bars): log-utility and scenario
weights and duals <= 5e-4, objective <= 1e-5 (scenario: 5e-5);
mean-variance weights <= 5e-5, objective <= 1e-6 (a real QP, no flat
faces). Measured differences are about 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmpc_tpu.ops import mpc_pallas as JP
from kmpc_tpu.ops.mpc import MPCParams as JParams
from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams

W_TOL, OBJ_TOL, SCEN_OBJ_TOL = 5e-4, 1e-5, 5e-5
MV_W_TOL, MV_OBJ_TOL = 5e-5, 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, **kw})


def _log_inputs(B, H, N, seed, S=None):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    shape = (B, H, N) if S is None else (B, S, H, N)
    ys = (rng.standard_normal(shape) * 0.01
          + (0.0005 if S is None else 0.0)).astype(np.float32)
    return cw, ys


def _np_info(info):
    return {k: np.asarray(v) for k, v in info.items()}


def _check_log(w, info, w_ref, info_ref, cw, p, obj_tol):
    w, info = w.numpy(), {k: (v.numpy() if torch.is_tensor(v) else v)
                          for k, v in info.items()}
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w, w_ref, atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["objective"], info_ref["objective"],
                               atol=obj_tol, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"],
                               info_ref["fixed_point_residual"], atol=W_TOL,
                               rtol=0)
    if "dual" in info_ref:
        np.testing.assert_allclose(info["dual"], info_ref["dual"],
                                   atol=W_TOL, rtol=0)
    near = np.abs(info_ref["fixed_point_residual"] - p.feas_tol) \
        <= 0.1 * p.feas_tol
    assert np.array_equal(info["status_code"][~near],
                          info_ref["status_code"][~near])
    w64 = w.astype(np.float64)
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= 1e-5) and np.all(w64 >= 0)
    if p.max_turnover > 0:
        prev = np.concatenate([cw.astype(np.float64)[:, None], w64[:, :-1]], 1)
        assert np.all(np.abs(w64 - prev).sum(-1) <= p.max_turnover + 1e-6)


# ---------------------------------------------------------------------------
# Kernel A: warm inputs and the dual output
# ---------------------------------------------------------------------------

# name: (B, H, N, params of the first solve). The continuation runs a
# quarter of the budget from the first solve's (primal, dual).
WARM_CASES = {
    "body_H5N20": (6, 5, 20, dict(max_iters=400)),
    "cond_H5N30_precond": (7, 5, 30, dict(max_iters=400, precond=True,
                                          proj_refresh_every=16)),
    "body_H1N12_over_relax": (8, 1, 12, dict(max_iters=300, over_relax=1.5)),
    "cold_proj_H5N33": (5, 5, 33, dict(max_iters=200, proj_warm_iters=0)),
}


@pytest.fixture(scope="module")
def warm_ref():
    cache = {}

    def get(name, S=None):
        key = (name, S)
        if key not in cache:
            B, H, N, kw = WARM_CASES[name]
            cw, ys = _log_inputs(B, H, N, seed=17 + B + N, S=S)
            solve = (JP.solve_mpc_log_utility_pallas_packed if S is None
                     else JP.solve_mpc_log_utility_scenarios_packed)
            w1, i1 = solve(jnp.asarray(cw), jnp.asarray(ys),
                           _params(kw, JParams), interpret=True,
                           return_dual=True)
            kw2 = dict(kw, max_iters=kw["max_iters"] // 4)
            w2, i2 = solve(jnp.asarray(cw), jnp.asarray(ys),
                           _params(kw2, JParams), interpret=True,
                           w_warm=w1, p_warm=i1["dual"], return_dual=True)
            cache[key] = (cw, ys, kw, kw2, np.asarray(w1), _np_info(i1),
                          np.asarray(w2), _np_info(i2))
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(WARM_CASES))
def test_log_utility_dual_output_matches_pallas(name, warm_ref):
    cw, ys, kw, _, w1, i1, _, _ = warm_ref(name)
    p = _params(kw)
    w, info = M.solve_mpc_log_utility_packed(_t(cw), _t(ys), p, device="cpu",
                                             return_dual=True)
    assert info["dual"].shape == ys.shape
    _check_log(w, info, w1, i1, cw, p, OBJ_TOL)


@pytest.mark.parametrize("name", list(WARM_CASES))
def test_log_utility_warm_continuation_matches_pallas(name, warm_ref):
    """Both sides continue from the same numpy iterates (the Pallas first
    solve's)."""
    cw, ys, _, kw2, w1, i1, w2, i2 = warm_ref(name)
    p = _params(kw2)
    w, info = M.solve_mpc_log_utility_packed(
        _t(cw), _t(ys), p, device="cpu", w_warm=_t(w1),
        p_warm=_t(i1["dual"]), return_dual=True)
    _check_log(w, info, w2, i2, cw, p, OBJ_TOL)


def test_log_utility_warm_primal_alone_starts_from_a_zero_dual():
    cw, ys = _log_inputs(5, 5, 20, seed=3)
    rng = np.random.default_rng(3)
    w0 = rng.dirichlet(np.ones(20), size=(5, 5)).astype(np.float32)
    kw = dict(max_iters=150)
    wj, ij = JP.solve_mpc_log_utility_pallas_packed(
        jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams),
        interpret=True, w_warm=jnp.asarray(w0))
    p = _params(kw)
    w, info = M.solve_mpc_log_utility_packed(_t(cw), _t(ys), p, device="cpu",
                                             w_warm=_t(w0))
    assert "dual" not in info
    _check_log(w, info, np.asarray(wj), _np_info(ij), cw, p, OBJ_TOL)
    zero, _ = M.solve_mpc_log_utility_packed(
        _t(cw), _t(ys), p, device="cpu", w_warm=_t(w0),
        p_warm=torch.zeros(5, 5, 20))
    assert torch.equal(w, zero)


def test_plain_version_takes_a_cold_threshold_on_the_warm_primal():
    """With zero iterations the output is the final half-step from the warm
    iterates as given: the warm primal is not projected first."""
    cw, ys = _log_inputs(4, 3, 9, seed=4)
    r = torch.exp(_t(ys))
    rng = np.random.default_rng(4)
    w0 = _t(rng.dirichlet(np.ones(9), size=(4, 3)).astype(np.float32))
    p0 = _t((rng.standard_normal((4, 3, 9)) * 1e-3).astype(np.float32))
    p = _params(dict(max_iters=0))
    w_last, fp, dual = M.pdhg_log_utility_plain(_t(cw), r, p, w0, p0, True)
    assert torch.equal(dual, p0)
    np.testing.assert_allclose(fp.numpy(),
                               (w_last - w0).abs().amax(dim=(1, 2)).numpy())


# ---------------------------------------------------------------------------
# Kernel B: scenario Kelly
# ---------------------------------------------------------------------------

SCEN_CASES = {
    "S4_H5N30": (6, 4, 5, 30, dict(max_iters=400)),
    "S4_H5N30_cond_precond": (6, 4, 5, 30, dict(
        max_iters=400, proj_refresh_every=16, precond=True)),
    "S4_H5N20_precond": (6, 4, 5, 20, dict(max_iters=400, precond=True)),
    "S3_H1N12": (7, 3, 1, 12, dict(max_iters=400)),
    "S4_H5N33_ridge": (5, 4, 5, 33, dict(max_iters=400, ridge=1e-3,
                                         feas_tol=3e-4)),
    "S4_no_ball": (6, 4, 5, 20, dict(max_iters=400, max_turnover=0.0)),
    "S4_over_relax": (6, 4, 5, 30, dict(max_iters=400, over_relax=1.5)),
    "S4_cold_proj": (6, 4, 5, 12, dict(max_iters=300, proj_warm_iters=0)),
}


@pytest.fixture(scope="module")
def scen_ref():
    cache = {}

    def get(name):
        if name not in cache:
            B, S, H, N, kw = SCEN_CASES[name]
            cw, scen = _log_inputs(B, H, N, seed=31 + len(cache), S=S)
            w, info = JP.solve_mpc_log_utility_scenarios_packed(
                jnp.asarray(cw), jnp.asarray(scen), _params(kw, JParams),
                tile_b=128, interpret=True)
            cache[name] = (cw, scen, np.asarray(w), _np_info(info))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SCEN_CASES))
def test_scenario_solve_cpu_matches_pallas_kernel(name, scen_ref):
    cw, scen, w_ref, info_ref = scen_ref(name)
    p = _params(SCEN_CASES[name][4])
    w, info = M.solve_mpc_log_utility_scenarios_packed(
        _t(cw), _t(scen), p, device="cpu")
    assert info["num_scenarios"] == SCEN_CASES[name][1]
    _check_log(w, info, w_ref, info_ref, cw, p, SCEN_OBJ_TOL)


@pytest.mark.parametrize("name", ["body_H5N20", "cond_H5N30_precond"])
def test_scenario_warm_continuation_matches_pallas(name, warm_ref):
    cw, scen, kw, kw2, w1, i1, w2, i2 = warm_ref(name, S=3)
    p = _params(kw)
    w, info = M.solve_mpc_log_utility_scenarios_packed(
        _t(cw), _t(scen), p, device="cpu", return_dual=True)
    _check_log(w, info, w1, i1, cw, p, SCEN_OBJ_TOL)
    p = _params(kw2)
    w, info = M.solve_mpc_log_utility_scenarios_packed(
        _t(cw), _t(scen), p, device="cpu", w_warm=_t(w1),
        p_warm=_t(i1["dual"]), return_dual=True)
    _check_log(w, info, w2, i2, cw, p, SCEN_OBJ_TOL)


def test_one_scenario_is_the_deterministic_program():
    cw, ys = _log_inputs(5, 5, 20, seed=5)
    p = _params(dict(max_iters=200, precond=True))
    w1, i1 = M.solve_mpc_log_utility_packed(_t(cw), _t(ys), p, device="cpu")
    ws, i_s = M.solve_mpc_log_utility_scenarios_packed(
        _t(cw), _t(ys[:, None]), p, device="cpu")
    np.testing.assert_allclose(ws.numpy(), w1.numpy(), atol=1e-6)
    np.testing.assert_allclose(i_s["objective"].numpy(),
                               i1["objective"].numpy(), atol=1e-6)


def test_scenario_wrapper_wants_four_axes():
    cw, ys = _log_inputs(3, 5, 20, seed=0)
    with pytest.raises(ValueError, match=r"\[B, S, H, N\]"):
        M.solve_mpc_log_utility_scenarios_packed(_t(cw), _t(ys), MPCParams(),
                                                 device="cpu")


@pytest.mark.parametrize("S,H,N,ok", [
    (16, 5, 20, True), (32, 5, 30, True), (16, 4, 128, True),
    (64, 8, 64, True),          # 128 KB: one warp per block
    (256, 5, 30, True),         # 160 KB
    (512, 5, 30, False),        # 320 KB > a block's shared memory
    (64, 8, 128, False),        # beyond the register budget
    (0, 5, 20, False),
])
def test_scenario_kernel_budget(S, H, N, ok):
    assert M.scenario_kernel_supports(S, H, N) is ok
    if ok:
        assert M.scenario_smem_bytes(S, H, N) == S * H * 32 * -(-N // 32) * 4


# ---------------------------------------------------------------------------
# Kernel C: mean-variance
# ---------------------------------------------------------------------------


def _mv_inputs(B, H, N, seed, shared):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N) if shared else (B, N, N)) * 0.05
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4
    # A slightly asymmetric input: the wrappers symmetrise it first.
    sig = sig + 1e-5 * np.triu(np.ones((N, N)), 1)
    return cw, mu, sig.astype(np.float32)


# name: (B, H, N, shared Sigma, params)
MV_CASES = {
    "H4N10": (6, 4, 10, False, dict(max_iters=600, gamma=5.0)),
    "H1N10_refresh": (6, 1, 10, False, dict(max_iters=600, gamma=5.0,
                                            proj_refresh_every=16)),
    "H3N12_shared": (5, 3, 12, True, dict(max_iters=600, gamma=5.0)),
    "H1N33_sigma_scale_1": (6, 1, 33, False, dict(
        max_iters=400, gamma=1.0, sigma_scale=1.0)),
    "H4N10_over_relax": (6, 4, 10, False, dict(max_iters=400, gamma=5.0,
                                               over_relax=1.5)),
    "H4N10_cold_proj": (6, 4, 10, False, dict(max_iters=300, gamma=5.0,
                                              proj_warm_iters=0)),
}


@pytest.fixture(scope="module")
def mv_ref():
    cache = {}

    def get(name):
        if name not in cache:
            B, H, N, shared, kw = MV_CASES[name]
            cw, mu, sig = _mv_inputs(B, H, N, 41 + len(cache), shared)
            w, info = JP.solve_mpc_mean_variance_pallas_packed(
                jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
                _params(kw, JParams), interpret=True)
            cache[name] = (cw, mu, sig, np.asarray(w), _np_info(info))
        return cache[name]

    return get


def _check_mv(w, info, w_ref, info_ref):
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w.numpy(), w_ref, atol=MV_W_TOL, rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], atol=MV_OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"].numpy(),
                               info_ref["fixed_point_residual"],
                               atol=MV_W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])
    w64 = w.double().numpy()
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= 1e-5) and np.all(w64 >= 0)


@pytest.mark.parametrize("name", list(MV_CASES))
def test_mean_variance_solve_cpu_matches_pallas_kernel(name, mv_ref):
    cw, mu, sig, w_ref, info_ref = mv_ref(name)
    w, info = V.solve_mpc_mean_variance_packed(
        _t(cw), _t(mu), _t(sig), _params(MV_CASES[name][4]), device="cpu")
    _check_mv(w, info, w_ref, info_ref)


def test_mean_variance_size_one_batch_sigma_is_shared(mv_ref):
    cw, mu, sig, w_ref, info_ref = mv_ref("H3N12_shared")
    w, info = V.solve_mpc_mean_variance_packed(
        _t(cw), _t(mu), _t(sig[None]), _params(MV_CASES["H3N12_shared"][4]),
        device="cpu")
    _check_mv(w, info, w_ref, info_ref)


def test_mean_variance_plain_version_against_the_eager_solver():
    """The kernel's arithmetic (multiply-and-sum Sigma w, clip-form dual,
    cold-start thresholds) against the eager solver's (matmul, zero-start
    thresholds) at the JAX kernel-vs-XLA bars."""
    from kmpc_tpu_torch.ops.mpc import solve_mpc_mean_variance_batch

    cw, mu, sig = _mv_inputs(6, 4, 10, 51, False)
    p = _params(dict(max_iters=1200, gamma=5.0))
    w_e, i_e = solve_mpc_mean_variance_batch(_t(cw), _t(mu), _t(sig), p)
    w_k, i_k = V.solve_mpc_mean_variance_packed(_t(cw), _t(mu), _t(sig), p,
                                                device="cpu")
    np.testing.assert_allclose(w_k.numpy(), w_e.numpy(), atol=MV_W_TOL)
    np.testing.assert_allclose(i_k["objective"].numpy(),
                               i_e["objective"].numpy(), atol=MV_OBJ_TOL)


def test_mean_variance_nan_forecast_holds_current_weights():
    from kmpc_tpu_torch.ops.mpc import STATUS_FAILURE

    cw, mu, sig = _mv_inputs(4, 2, 8, 52, False)
    mu[1, 0, 3] = np.nan
    w, info = V.solve_mpc_mean_variance_packed(
        _t(cw), _t(mu), _t(sig), _params(dict(max_iters=50, gamma=5.0)),
        device="cpu")
    assert not info["converged"][1] and info["converged"][[0, 2, 3]].all()
    assert info["status_code"][1].item() == STATUS_FAILURE
    assert torch.equal(w[1], _t(cw[1]).expand(2, 8))
    assert torch.isfinite(w).all()


@pytest.mark.parametrize("H,N,ok", [(1, 20, True), (1, 30, True),
                                    (1, 128, True), (2, 20, False),
                                    (5, 129, False), (1, 129, False)])
def test_mean_variance_kernel_budget(H, N, ok):
    assert V.mv_kernel_supports(H, N) is ok
    assert V.mv_smem_bytes(N) == N * 32 * -(-N // 32) * 4
    assert V.mv_smem_bytes(128) == 65536


# ---------------------------------------------------------------------------
# The adaptive body (residual-balancing steps) of kernels A, B and C
# ---------------------------------------------------------------------------

ACCURATE = dict(adaptive=True, adapt_every=2, precond=True)

# name: (B, H, N, params, warm continuation too)
ADAPTIVE_CASES = {
    "k1_H5N20": (6, 5, 20, dict(max_iters=400, adaptive=True), False),
    "k2_H5N20": (6, 5, 20, dict(max_iters=400, adaptive=True,
                                adapt_every=2), False),
    "k1_precond_H5N30": (6, 5, 30, dict(max_iters=400, adaptive=True,
                                        precond=True), False),
    "k2_precond_H1N12": (7, 1, 12, dict(max_iters=400, **ACCURATE), False),
    "ridge_H5N33": (5, 5, 33, dict(max_iters=400, ridge=1e-3, feas_tol=3e-4,
                                   **ACCURATE), False),
    "over_relax": (6, 5, 30, dict(max_iters=400, over_relax=1.5, **ACCURATE),
                   False),
    "no_ball": (6, 5, 20, dict(max_iters=400, max_turnover=0.0, **ACCURATE),
                False),
    "cold_proj": (6, 5, 12, dict(max_iters=300, proj_warm_iters=0,
                                 **ACCURATE), False),
    "odd_iters_k3": (6, 5, 20, dict(max_iters=301, adaptive=True,
                                    adapt_every=3), False),
    "refresh_is_ignored": (6, 5, 20, dict(
        max_iters=300, proj_refresh_every=16, pipeline_reduces=True,
        **ACCURATE), False),
    "warm_and_dual": (6, 5, 20, dict(max_iters=400, **ACCURATE), True),
    "accurate_setting_800": (4, 5, 30, dict(max_iters=800, feas_tol=2e-4,
                                            **ACCURATE), False),
}


@pytest.mark.parametrize("name", list(ADAPTIVE_CASES))
def test_adaptive_log_utility_cpu_matches_pallas_kernel(name):
    """``body_adaptive`` with its ``adapt_every`` schedule; the warm case
    continues a quarter of the budget from the Pallas first solve's
    iterates on both sides."""
    B, H, N, kw, warm = ADAPTIVE_CASES[name]
    cw, ys = _log_inputs(B, H, N, seed=61 + B + N)
    w1, i1 = JP.solve_mpc_log_utility_pallas_packed(
        jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams),
        interpret=True, return_dual=True)
    p = _params(kw)
    w, info = M.solve_mpc_log_utility_packed(_t(cw), _t(ys), p, device="cpu",
                                             return_dual=True)
    _check_log(w, info, np.asarray(w1), _np_info(i1), cw, p, OBJ_TOL)
    if warm:
        kw2 = dict(kw, max_iters=kw["max_iters"] // 4)
        w2, i2 = JP.solve_mpc_log_utility_pallas_packed(
            jnp.asarray(cw), jnp.asarray(ys), _params(kw2, JParams),
            interpret=True, w_warm=w1, p_warm=i1["dual"], return_dual=True)
        p = _params(kw2)
        w, info = M.solve_mpc_log_utility_packed(
            _t(cw), _t(ys), p, device="cpu", w_warm=_t(w1),
            p_warm=_t(i1["dual"]), return_dual=True)
        _check_log(w, info, np.asarray(w2), _np_info(i2), cw, p, OBJ_TOL)


def test_adaptive_body_ignores_the_refresh_schedule():
    cw, ys = _log_inputs(5, 5, 20, seed=9)
    kw = dict(max_iters=120, **ACCURATE)
    w1, _ = M.solve_mpc_log_utility_packed(_t(cw), _t(ys), _params(kw),
                                           device="cpu")
    w2, _ = M.solve_mpc_log_utility_packed(
        _t(cw), _t(ys), _params(dict(kw, proj_refresh_every=16,
                                     pipeline_reduces=True)), device="cpu")
    assert torch.equal(w1, w2)


def test_accurate_setting_reaches_the_probe_bar():
    """The 64 bench probe instances (seed 1234, H=5, N=30) at the accurate
    setting against the float64 oracle objectives of bench_probe_cache.json:
    median gap <= 1.5e-4, and several times under the fixed-step bench
    setting's at a similar budget. The steps do move: the last tau differs
    from problem to problem and from the initial one."""
    import json
    from pathlib import Path

    rng = np.random.default_rng(1234)
    cw = rng.dirichlet(np.ones(30), size=64).astype(np.float32)
    ys = (rng.standard_normal((64, 5, 30)) * 0.01 + 0.0005).astype(np.float32)
    cache = Path(__file__).resolve().parents[1] / "bench_probe_cache.json"
    oracle = np.asarray(json.loads(cache.read_text())
                        ["log_H5_N30_n64_seed1234"])

    def gap(kw):
        w, _ = M.solve_mpc_log_utility_packed(_t(cw), _t(ys), _params(kw),
                                              device="cpu")
        w = w.double().numpy()
        r = np.exp(ys.astype(np.float64))
        prev = np.concatenate([cw.astype(np.float64)[:, None], w[:, :-1]], 1)
        obj = -np.log((w * r).sum(-1)).sum(-1) \
            + 0.001 * np.abs(w - prev).sum((-2, -1))
        return float(np.median(obj - oracle))

    accurate = gap(dict(max_iters=800, feas_tol=2e-4, **ACCURATE))
    fixed = gap(dict(max_iters=1000, feas_tol=2e-4, precond=True,
                     proj_refresh_every=16))
    assert accurate <= 1.5e-4, accurate
    assert fixed > 3 * accurate, (fixed, accurate)

    r = torch.exp(_t(ys))
    p0 = _params(dict(max_iters=0, **ACCURATE))
    p1 = _params(dict(max_iters=200, **ACCURATE))
    start = M.pdhg_log_utility_plain(_t(cw), r, p0, return_steps=True)[2]
    end = M.pdhg_log_utility_plain(_t(cw), r, p1, return_steps=True)[2]
    assert start.shape == end.shape == (64, 14)
    assert torch.all(start[:, 10] == 0.5) and torch.all(end[:, 10] < 0.5)
    assert torch.all(start[:, 11:] == 0) and torch.all(end[:, 11:13] > 0)
    # The signed sum of the iterations that moved the steps: whole numbers,
    # no larger than if every balancing (iterations 2, 4, ..., 200) had.
    moved = end[:, 13]
    assert torch.all(moved == moved.round()) and torch.all(moved != 0)
    assert moved.abs().max() <= sum(range(2, 201, 2))
    assert ((end[:, 0] / start[:, 0] - 1).abs() > 0.05).all()
    with pytest.raises(ValueError, match="return_steps"):
        M.pdhg_log_utility_plain(_t(cw), r, _params(dict(max_iters=1)),
                                 return_steps=True)


ADAPTIVE_SCEN_CASES = {
    "S4_H5N20_k2_precond": (6, 4, 5, 20, dict(max_iters=400, **ACCURATE)),
    "S3_H1N12_k1": (7, 3, 1, 12, dict(max_iters=400, adaptive=True)),
    "S4_H5N33_k3_over_relax": (5, 4, 5, 33, dict(
        max_iters=301, adaptive=True, adapt_every=3, over_relax=1.5)),
}


@pytest.mark.parametrize("name", list(ADAPTIVE_SCEN_CASES))
def test_adaptive_scenario_solve_cpu_matches_pallas_kernel(name):
    B, S, H, N, kw = ADAPTIVE_SCEN_CASES[name]
    cw, scen = _log_inputs(B, H, N, seed=71 + S + N, S=S)
    w_ref, info_ref = JP.solve_mpc_log_utility_scenarios_packed(
        jnp.asarray(cw), jnp.asarray(scen), _params(kw, JParams), tile_b=128,
        interpret=True, return_dual=True)
    p = _params(kw)
    w, info = M.solve_mpc_log_utility_scenarios_packed(
        _t(cw), _t(scen), p, device="cpu", return_dual=True)
    _check_log(w, info, np.asarray(w_ref), _np_info(info_ref), cw, p,
               SCEN_OBJ_TOL)


ADAPTIVE_MV_CASES = {
    "H4N10_k2": (6, 4, 10, False, dict(max_iters=600, gamma=5.0,
                                       adaptive=True, adapt_every=2)),
    "H1N12_shared_k1": (6, 1, 12, True, dict(max_iters=600, gamma=5.0,
                                             adaptive=True)),
    "H3N12_shared_k2_over_relax": (5, 3, 12, True, dict(
        max_iters=401, gamma=5.0, adaptive=True, adapt_every=2,
        over_relax=1.5, proj_refresh_every=16)),
    "H1N33_k3_sigma_scale_1": (6, 1, 33, False, dict(
        max_iters=400, gamma=1.0, sigma_scale=1.0, adaptive=True,
        adapt_every=3)),
}


@pytest.mark.parametrize("name", list(ADAPTIVE_MV_CASES))
def test_adaptive_mean_variance_cpu_matches_pallas_kernel(name):
    B, H, N, shared, kw = ADAPTIVE_MV_CASES[name]
    cw, mu, sig = _mv_inputs(B, H, N, 81 + H + N, shared)
    w_ref, info_ref = JP.solve_mpc_mean_variance_pallas_packed(
        jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
        _params(kw, JParams), interpret=True)
    w, info = V.solve_mpc_mean_variance_packed(
        _t(cw), _t(mu), _t(sig), _params(kw), device="cpu")
    _check_mv(w, info, np.asarray(w_ref), _np_info(info_ref))


def test_mean_variance_plain_version_returns_the_steps_it_ended_on():
    """[B, 6]: tau, sigma, alpha, the last balancing's residuals and the
    signed sum of the iterations that moved the steps, per problem also
    under a shared covariance; only the adaptive body has them."""
    cw, mu, sig = _mv_inputs(5, 2, 8, 90, True)
    sym = _t(0.5 * (sig + sig.T))
    p = _params(dict(max_iters=60, gamma=5.0, adaptive=True, adapt_every=2))
    w, fp, steps = V.pdhg_mean_variance_plain(_t(cw), _t(mu), sym, p,
                                              return_steps=True)
    w2, fp2 = V.pdhg_mean_variance_plain(_t(cw), _t(mu), sym, p)
    assert torch.equal(w, w2) and torch.equal(fp, fp2)
    assert steps.shape == (5, 6) and torch.all(steps[:, :5] > 0)
    assert torch.all(steps[:, 5] == steps[:, 5].round())
    assert torch.all(steps[:, 2] < 0.5)            # every problem adapted
    assert steps[:, 0].unique().numel() > 1        # and not in step
    start = V.pdhg_mean_variance_plain(
        _t(cw), _t(mu), sym, _params(dict(max_iters=0, gamma=5.0,
                                          adaptive=True)),
        return_steps=True)[2]
    assert torch.all(start[:, 2] == 0.5) and torch.all(start[:, 3:] == 0)
    assert start[:, 0].unique().numel() == 1       # one shared covariance
    with pytest.raises(ValueError, match="return_steps"):
        V.pdhg_mean_variance_plain(_t(cw), _t(mu), sym,
                                   _params(dict(max_iters=1)),
                                   return_steps=True)


# ---------------------------------------------------------------------------
# What the wrappers refuse
# ---------------------------------------------------------------------------


def test_cuda_wrappers_refuse_cpu_tensors():
    cw, scen = _log_inputs(3, 5, 20, seed=0, S=4)
    with pytest.raises(ValueError, match="CUDA"):
        M.pdhg_log_utility_cuda(_t(cw), torch.exp(_t(scen)), MPCParams())
    cw, mu, sig = _mv_inputs(3, 1, 20, 0, False)
    with pytest.raises(ValueError, match="CUDA"):
        V.pdhg_mean_variance_cuda(_t(cw), _t(mu), _t(sig), MPCParams())


@pytest.mark.parametrize("bad", ["weights", "sigma", "warm"])
def test_cuda_wrappers_check_shapes_before_launch(bad):
    with pytest.raises(ValueError, match="expected"):
        if bad == "weights":
            V.pdhg_mean_variance_cuda(torch.ones(3, 21), torch.ones(3, 1, 20),
                                      torch.ones(3, 20, 20), MPCParams())
        elif bad == "sigma":
            V.pdhg_mean_variance_cuda(torch.ones(3, 20), torch.ones(3, 1, 20),
                                      torch.ones(2, 20, 20), MPCParams())
        else:
            M.pdhg_log_utility_cuda(torch.ones(3, 20), torch.ones(3, 5, 20),
                                    MPCParams(), w_warm=torch.ones(3, 4, 20))


@pytest.mark.parametrize("field,value,exc", [
    ("allow_short", True, NotImplementedError),
    ("polish", True, ValueError),
])
@pytest.mark.parametrize("solver", ["scenarios", "mean_variance"])
def test_unported_parameters_raise(solver, field, value, exc):
    p = dataclasses.replace(MPCParams(max_iters=10), **{field: value})
    with pytest.raises(exc):
        if solver == "scenarios":
            cw, scen = _log_inputs(3, 5, 20, seed=0, S=2)
            M.solve_mpc_log_utility_scenarios_packed(_t(cw), _t(scen), p,
                                                     device="cpu")
        else:
            cw, mu, sig = _mv_inputs(3, 1, 20, 0, False)
            V.solve_mpc_mean_variance_packed(_t(cw), _t(mu), _t(sig), p,
                                             device="cpu")


@pytest.mark.parametrize("solver", ["log", "scenarios", "mean_variance"])
def test_allow_short_raises_and_names_the_eager_solver(solver):
    """The kernels project on the simplex only: the packed wrappers raise
    on ``allow_short``, with warm inputs and the dual output too, instead
    of returning a long-only solution or another solver's; the eager
    solver named in the message does take shorts on the same inputs."""
    from kmpc_tpu_torch.ops.mpc import (
        solve_mpc_log_utility_batch, solve_mpc_mean_variance_batch,
    )
    from kmpc_tpu_torch.ops.scenario import solve_mpc_log_utility_scenarios

    p = _params(dict(max_iters=200, allow_short=True, gamma=5.0))
    if solver == "log":
        cw, ys = _log_inputs(4, 5, 10, seed=6)
        w_e, _ = solve_mpc_log_utility_batch(_t(cw), _t(ys), p)
        with pytest.raises(NotImplementedError,
                           match="solve_mpc_log_utility_batch"):
            M.solve_mpc_log_utility_packed(_t(cw), _t(ys), p, device="cpu",
                                           w_warm=w_e, return_dual=True)
    elif solver == "scenarios":
        cw, scen = _log_inputs(4, 5, 10, seed=6, S=3)
        w_e, _ = solve_mpc_log_utility_scenarios(_t(cw), _t(scen), p)
        with pytest.raises(NotImplementedError,
                           match="solve_mpc_log_utility_scenarios"):
            M.solve_mpc_log_utility_scenarios_packed(_t(cw), _t(scen), p,
                                                     device="cpu")
    else:
        cw, mu, sig = _mv_inputs(4, 3, 8, 6, False)
        w_e, _ = solve_mpc_mean_variance_batch(_t(cw), _t(mu), _t(sig), p)
        with pytest.raises(NotImplementedError,
                           match="solve_mpc_mean_variance_batch"):
            V.solve_mpc_mean_variance_packed(_t(cw), _t(mu), _t(sig), p,
                                             device="cpu")
    assert w_e.min().item() < -1e-6       # shorts do occur
    assert torch.allclose(w_e.sum(-1), torch.ones(()), atol=1e-5)


def test_direct_kernel_entry_points_refuse_allow_short():
    cw, ys = _log_inputs(3, 5, 10, seed=0)
    p = MPCParams(max_iters=5, allow_short=True)
    with pytest.raises(NotImplementedError, match="simplex"):
        M.pdhg_log_utility_plain(_t(cw), torch.exp(_t(ys)), p)
    cw, mu, sig = _mv_inputs(3, 1, 10, 0, False)
    with pytest.raises(NotImplementedError, match="simplex"):
        V.pdhg_mean_variance_plain(_t(cw), _t(mu), _t(sig), p)


def test_every_kernel_has_a_source_and_a_launch_counter():
    from kmpc_tpu_torch._build import CSRC, SOURCES, library_path

    from kmpc_tpu_torch.ops.mv_ladder import MV_LADDER

    kernels = M.KERNELS + V.MV_KERNELS + (MV_LADDER,)
    assert len(kernels) == 27
    assert {k.name for k in kernels} == set(SOURCES)
    for k in kernels:
        assert k.launches == 0          # nothing launches on the CPU
        src = (CSRC / SOURCES[k.name]).read_text()
        assert f'extern "C" int {k.symbol}(' in src
        assert library_path(k.name).name.startswith(f"lib{k.name}_")
    assert len({library_path(k.name) for k in kernels}) == len(kernels)


# ---------------------------------------------------------------------------
# The parting trace (python -m kmpc_tpu_torch.ops.adaptive_parting)
# ---------------------------------------------------------------------------


def _fake_run(parts_at, margin):
    """Two runs whose step histories differ from iteration ``parts_at`` on,
    the residuals of the last balancing ``margin`` either side of a tie."""
    def run(n):
        a, b = torch.zeros(1, 6), torch.zeros(1, 6)
        a[0, 3:5] = torch.tensor([1.5 * (1 + margin), 1.0])
        b[0, 3:5] = torch.tensor([1.5 * (1 - margin), 1.0])
        if n > parts_at:
            a[0, 5] = parts_at + 1.0
        x = torch.zeros(1, 2, 3)
        return [(a, x), (b, x + 1e-7)]
    return run


@pytest.mark.parametrize("parts_at", [0, 1, 137, 798, 799])
def test_first_parting_finds_the_first_differing_decision(parts_at):
    from kmpc_tpu_torch.ops import adaptive_parting as P

    t = P.first_parting(_fake_run(parts_at, 1e-5), 800)
    assert t["iteration"] == parts_at
    assert t["tie_margin_kernel"] == pytest.approx(1e-5, rel=1e-2)
    assert t["tie_margin_plain"] == pytest.approx(1e-5, rel=1e-2)
    assert t["max_abs_diff_before"] == pytest.approx(1e-7)
    assert max(t["tie_margin_kernel"], t["tie_margin_plain"]) <= P.TIE_TOL


def test_first_parting_is_none_for_equal_histories():
    from kmpc_tpu_torch.ops import adaptive_parting as P

    assert P.first_parting(_fake_run(800, 1e-5), 800) is None
    # Two runs of the plain version have one history, and the residuals of
    # a decision far from a tie are no tie.
    cw, ys = _log_inputs(4, 5, 20, seed=5)
    p = _params(dict(max_iters=120, **ACCURATE))
    r = torch.exp(_t(ys))
    a = M.pdhg_log_utility_plain(_t(cw), r, p, return_steps=True)[2]
    b = M.pdhg_log_utility_plain(_t(cw), r.clone(), p, return_steps=True)[2]
    assert not P.histories_differ(a, b).any()
    assert torch.all(P.tie_margin(a) >= 0)
    far = torch.tensor([[0.1, 0.1, 0.5, 3.0, 1.0, 7.0]])   # pr = 3 dr
    assert P.tie_margin(far).item() == pytest.approx(7.0 / 9.0)


def test_parting_script_needs_the_card(capsys):
    from kmpc_tpu_torch.ops import adaptive_parting as P

    assert not torch.cuda.is_available()
    assert P.main() == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert set(P.seeded_cases()) >= {
        "A_path_shape", "B_path_shape", "C_path_shape", "A_scan_shape"}


def test_parting_trace_of_a_case_end_to_end(monkeypatch):
    """``trace_case`` on the CPU, with a stand-in for the kernel: the plain
    version on returns that differ in the last bit, as a kernel's sums do."""
    from kmpc_tpu_torch.ops import adaptive_parting as P

    def last_bit(cw, r, p, **kw):
        return M.pdhg_log_utility_plain(cw, r * (1.0 + 1.2e-7), p, **kw)

    monkeypatch.setattr(M, "pdhg_log_utility_cuda", last_bit)
    cw, ys = _log_inputs(12, 5, 20, seed=9)
    p = _params(dict(max_iters=300, **ACCURATE))
    res, failed = P.trace_case(
        "stand_in", lambda: P._log_case(_t(cw), torch.exp(_t(ys)), p), 4)
    assert res["B"] == 12 and res["iters"] == 300
    for pair in ("kernel_vs_plain", "kernel_vs_float64_plain",
                 "plain_vs_float64_plain"):
        assert res[pair]["max_abs_dobj"] <= 3e-4, res[pair]
        assert res[pair]["ended_apart_with_equal_histories"] == 0, res[pair]
    assert len(res["traced"]) <= res["kernel_vs_plain"]["ended_apart"]
    for t in res["traced"]:
        assert 0 <= t["iteration"] < 300 and t["iteration"] % 2 == 1
    assert not failed, failed


@pytest.mark.parametrize("in_batch", [False, True])
def test_parting_trace_in_batch(in_batch):
    """A parting that shows only in its batch: the stand-in kernel is the
    plain version on returns 1e-6 off when it is given more than one
    problem, as a plain version's sums take another order at another batch
    size. Problem 4 of the batch parts there; re-run alone it does not
    (``trace_problem`` gives None), traced in its batch (``in_batch``) its
    first differing decision is found."""
    from kmpc_tpu_torch.ops import adaptive_parting as P

    def batch_dependent(cw, r, p, **kw):
        return M.pdhg_log_utility_plain(
            cw, r * (1.0 + 1e-6 * (r.shape[0] > 1)), p, **kw)

    cw, ys = _log_inputs(12, 5, 20, seed=11)
    p = _params(dict(max_iters=800, **ACCURATE))
    solve, fns, _, _, iters = P._log_case(_t(cw), torch.exp(_t(ys)), p,
                                          kernel=batch_dependent)
    whole = [solve(f, slice(None), iters)[3] for f in fns[:2]]
    assert P.histories_differ(*whole).nonzero()[:, 0].tolist() == [4]
    t = P.trace_problem(solve, fns, 4, iters, in_batch=in_batch)
    if not in_batch:
        assert t is None
        return
    assert 0 <= t["iteration"] < iters and t["iteration"] % 2 == 1
    assert t["max_abs_diff_before"] <= P.W_TOL
    assert max(t["tie_margin_kernel"], t["tie_margin_plain"]) <= P.DRIFT_TIE_TOL


def test_n500_parting_is_classified_on_the_plain_versions():
    """The N=500 classification (``adaptive_parting --n500``) on the CPU:
    the seed-30 case of ``adaptive_block_H5N500`` with the plain version
    under another summation order (its assets permuted) as the kernel is
    float32's limit; a kernel that stops at half its iterations is
    convicted."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import adaptive_parting as P

    cw, r = P.n500_inputs("cpu")
    assert cw.shape == (4, 500) and r.shape == (4, 5, 500)
    params = MPCParams(**P.N500_PARAMS)

    def half(c, rr, pp, **kw):
        return M.pdhg_log_utility_plain(
            c, rr, replace(pp, max_iters=max(pp.max_iters // 2, 1)), **kw)

    res = P.classify(cw, r, params, {
        "other_order": P.permuted(M.pdhg_log_utility_plain, 1),
        "half_iterations": half}, sample=1)
    assert set(res["problems"]) == {"other_order", "half_iterations",
                                    "plain", "plain_permuted",
                                    "plain_float64"}
    assert res["convicted"]["other_order"] == []
    assert res["convicted"]["half_iterations"]
    assert res["verdict"] == "kernel"
    for entry in res["apart"]["other_order"]:
        assert "plain_float64" in entry["shares_history"]
    for name, traced in res["traces"].items():
        assert traced["in_batch"] is True and traced["B"] == 4
    alone = P.classify(cw, r, params, {
        "other_order": P.permuted(M.pdhg_log_utility_plain, 1)}, sample=1)
    assert alone["verdict"] == "float32"


# The plain versions' loop goes through ``mpc_cuda._plain_iterate``, which
# ``plain_replayed`` swaps for replays of a CUDA graph whose length is a
# multiple of the loop's period (the iterations' schedule repeats with it).
# Each case: the parameters, and the period of the log-utility and the
# mean-variance loop (kernel C has no pipelined body: its refresh schedule).
_PERIOD_CASES = {
    "fixed": (dict(max_iters=37), 1, 1),
    "refresh": (dict(max_iters=37, proj_refresh_every=16, precond=True),
                16, 16),
    "pipelined": (dict(max_iters=37, proj_refresh_every=16, precond=True,
                       pipeline_reduces=True), 8, 16),
    "adaptive": (dict(max_iters=37, adaptive=True, adapt_every=2,
                      precond=True), 2, 2),
    "adaptive_k1": (dict(max_iters=37, adaptive=True, adapt_every=1), 1, 1),
}


@pytest.mark.parametrize("name", sorted(_PERIOD_CASES))
def test_plain_loop_hook_takes_the_schedule_period(name, monkeypatch):
    """Each plain version hands the hook every iteration and its period;
    under ``plain_replayed`` on CPU tensors (no graph: the eager loop) the
    outputs are the same bits, and the hook is restored after the block."""
    kw, period, mv_period = _PERIOD_CASES[name]
    p = _params(kw)
    rng = np.random.default_rng(7)
    cw = _t(rng.dirichlet(np.ones(9), size=3).astype(np.float32))
    r = torch.exp(_t((rng.standard_normal((3, 4, 9)) * 0.01)
                     .astype(np.float32)))
    mu = _t((rng.standard_normal((3, 4, 9)) * 0.01).astype(np.float32))
    a = rng.standard_normal((3, 9, 9)).astype(np.float32)
    sig = _t(a @ a.transpose(0, 2, 1) * 0.01)
    steps = dict(return_steps=True) if p.adaptive else {}

    def run():
        return (M.pdhg_log_utility_plain(cw, r, p, return_dual=True, **steps)
                + V.pdhg_mean_variance_plain(cw, mu, sig, p, **steps))

    before = run()
    seen = []
    eager = M._plain_iterate

    def recording(step, carry, n, per):
        seen.append((n, per))
        return eager(step, carry, n, per)

    monkeypatch.setattr(M, "_plain_iterate", recording)
    recorded = run()
    monkeypatch.setattr(M, "_plain_iterate", eager)
    assert seen == [(37, period), (37, mv_period)]
    with M.plain_replayed():
        assert M._plain_iterate is not eager
        replayed = run()
    assert M._plain_iterate is eager
    for x, y, z in zip(before, recorded, replayed):
        assert torch.equal(x, y) and torch.equal(x, z)
