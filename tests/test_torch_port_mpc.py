"""kmpc_tpu_torch's fused log-utility solve against kmpc_tpu's Pallas kernel.

The JAX reference is ``solve_mpc_log_utility_pallas_packed`` in interpret
mode on the CPU, exactly as tests/test_mpc_pallas.py runs it; the port runs
the kernel's plain PyTorch version (``pdhg_log_utility_plain``) and its CPU
entry point. Every interpret-mode reference is computed once per module.

Bars (the repository's kernel-vs-XLA bars): objective <= 1e-5, weights
<= 5e-4 (weights may move along near-flat faces of this LP-like program, so
the objective is the binding bar), equal status codes except for problems
whose fixed-point residual lies within 10% of feas_tol (summation order can
move them across the band), outputs on the simplex to 1e-5 and per-step
turnover <= max_turnover + 1e-6 after restoration.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmpc_tpu.ops.mpc import MPCParams as JParams
from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops.mpc import MPCParams

OBJ_TOL = 1e-5
W_TOL = 5e-4
BAND = 0.1


def _instance(B, H, N, seed, nan_row=False):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01 + 0.0005).astype(np.float32)
    if nan_row:
        ys[2, H - 1, N // 2] = np.nan
    return cw, ys


# name: (B, H, N, params, nan_row). Refresh 0 is the kernel's make_body,
# refresh 16 its make_body_cond; feas_tol 3e-4 sits inside the residual
# range at these budgets, so both status bands occur.
CASES = {
    "body_H5N20": (6, 5, 20, dict(max_iters=400), False),
    "body_H5N20_precond_ridge": (
        7, 5, 20, dict(max_iters=400, precond=True, ridge=1e-3,
                       feas_tol=3e-4), False),
    "cond_H5N30": (8, 5, 30, dict(max_iters=500, proj_refresh_every=16,
                                  feas_tol=3e-4), False),
    "cond_H5N30_precond": (9, 5, 30, dict(max_iters=500, precond=True,
                                          proj_refresh_every=16), False),
    "body_H1N12": (8, 1, 12, dict(max_iters=300), False),
    "cond_H1N33_precond": (6, 1, 33, dict(max_iters=300, precond=True,
                                          proj_refresh_every=16), False),
    "body_H5N33": (7, 5, 33, dict(max_iters=400, feas_tol=3e-4), False),
    "cond_H5N12": (9, 5, 12, dict(max_iters=600, proj_refresh_every=16),
                   False),
    "no_ball_H5N20": (8, 5, 20, dict(max_iters=400, max_turnover=0.0,
                                     feas_tol=3e-4), False),
    "over_relax_cond_H5N30": (7, 5, 30, dict(max_iters=400, over_relax=1.5,
                                             proj_refresh_every=16), False),
    "cold_H5N33": (6, 5, 33, dict(max_iters=300, proj_warm_iters=0), False),
    "nan_row_H5N20": (6, 5, 20, dict(max_iters=300), True),
}


def _params(kw, cls=MPCParams):
    return cls(sigma_scale=2.0, **kw)


@pytest.fixture(scope="module")
def pallas_ref():
    """Interpret-mode kmpc_tpu solves, computed once per case."""
    from kmpc_tpu.ops.mpc_pallas import solve_mpc_log_utility_pallas_packed

    cache = {}

    def get(name):
        if name not in cache:
            B, H, N, kw, nan_row = CASES[name]
            cw, ys = _instance(B, H, N, seed=len(cache) + 11 * B + N,
                               nan_row=nan_row)
            w, info = solve_mpc_log_utility_pallas_packed(
                jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams),
                tile_b=128, interpret=True,
            )
            cache[name] = (cw, ys, np.asarray(w),
                           {k: np.asarray(v) for k, v in info.items()})
        return cache[name]

    return get


def _check_against_ref(name, ref, w, info):
    cw, ys, w_ref, info_ref = ref
    p = _params(CASES[name][3])
    w, info = w.numpy(), {k: v.numpy() for k, v in info.items()}
    assert set(info) == set(info_ref)
    assert w.shape == w_ref.shape and w.dtype == np.float32
    np.testing.assert_allclose(w, w_ref, atol=W_TOL, rtol=0)
    # A NaN forecast makes the objective NaN on both paths.
    np.testing.assert_allclose(info["objective"], info_ref["objective"],
                               atol=OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"],
                               info_ref["fixed_point_residual"], atol=W_TOL,
                               rtol=0)
    fp_ref = info_ref["fixed_point_residual"]
    near = np.abs(fp_ref - p.feas_tol) <= BAND * p.feas_tol
    for key in ("status_code", "converged"):
        assert np.array_equal(info[key][~near], info_ref[key][~near]), key
    np.testing.assert_allclose(info["turnover_violation"],
                               info_ref["turnover_violation"], atol=W_TOL,
                               rtol=0)
    # Feasibility after restoration, in float64.
    w64 = w.astype(np.float64)
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= 1e-5)
    assert np.all(w64 >= 0.0)
    if p.max_turnover > 0:
        prev = np.concatenate([cw.astype(np.float64)[:, None], w64[:, :-1]], 1)
        assert np.all(np.abs(w64 - prev).sum(-1) <= p.max_turnover + 1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_cpu_matches_pallas_kernel(name, pallas_ref):
    ref = pallas_ref(name)
    cw, ys = ref[0], ref[1]
    w, info = M.solve_mpc_log_utility_packed(
        torch.as_tensor(cw), torch.as_tensor(ys), _params(CASES[name][3]),
        device="cpu",
    )
    _check_against_ref(name, ref, w, info)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_kernel(name, pallas_ref):
    """The plain version's iterate and residual, through the port's own
    finalisation, against the kernel's."""
    ref = pallas_ref(name)
    cw, ys = ref[0], ref[1]
    p = _params(CASES[name][3])
    w0 = torch.as_tensor(cw)
    r = torch.exp(torch.as_tensor(ys))
    w_last, fp = M.pdhg_log_utility_plain(w0, r, p)
    assert w_last.shape == r.shape and fp.shape == (r.shape[0],)
    w, info = M._finalize_packed(w_last, r, w0, p, fp)
    _check_against_ref(name, ref, w, info)


def test_nan_forecast_holds_current_weights():
    from kmpc_tpu_torch.ops.mpc import STATUS_FAILURE

    B, H, N, kw, _ = CASES["nan_row_H5N20"]
    cw, ys = _instance(B, H, N, seed=5, nan_row=True)
    w, info = M.solve_mpc_log_utility_packed(
        torch.as_tensor(cw), torch.as_tensor(ys), _params(kw), device="cpu")
    assert info["status_code"][2].item() == STATUS_FAILURE
    assert not info["converged"][2].item()
    assert torch.equal(w[2], torch.as_tensor(cw[2]).expand(H, N))
    assert torch.isfinite(w).all()
    others = torch.arange(B) != 2
    assert (info["status_code"][others] != STATUS_FAILURE).all()


@pytest.mark.parametrize("H,N", [(1, 7), (5, 20), (5, 30), (5, 33), (2, 64)])
@pytest.mark.parametrize("refresh", [0, 4])
def test_plain_version_refresh_schedule_stays_feasible(H, N, refresh):
    """Plain-version-only sweep over shapes and schedules: the returned
    iterate is on the simplex and the residual is small and finite."""
    cw, ys = _instance(5, H, N, seed=H * 100 + N + refresh)
    p = _params(dict(max_iters=300, proj_refresh_every=refresh))
    w, info = M.solve_mpc_log_utility_packed(
        torch.as_tensor(cw), torch.as_tensor(ys), p, device="cpu")
    assert torch.allclose(w.double().sum(-1), torch.ones(5, H).double(),
                          atol=1e-5)
    assert (w >= 0).all()
    fp = info["fixed_point_residual"]
    assert torch.isfinite(fp).all() and fp.max().item() < 1e-2


def test_cuda_wrapper_refuses_cpu_tensors():
    cw, ys = _instance(4, 5, 20, seed=0)
    r = torch.exp(torch.as_tensor(ys))
    with pytest.raises(ValueError, match="CUDA"):
        M.pdhg_log_utility_cuda(torch.as_tensor(cw), r, MPCParams())


def test_cuda_wrapper_checks_shapes_before_launch():
    r = torch.ones(3, 5, 20)
    with pytest.raises(ValueError, match="expected"):
        M.pdhg_log_utility_cuda(torch.ones(3, 21), r, MPCParams())


def _budget_case(H, N, warp, block, S=None):
    """A (S, H, N) case of the kernels' budgets, with the id it had when only
    the warp layout was checked (its H, N and warp fit)."""
    label = f"{H}-{N}-{warp}" if S is None and block is None else \
        f"S{S}-H{H}-N{N}-{warp}-{block}"
    return pytest.param(S, H, N, warp, block, id=label)


# (S, H, N, warp layout, block layout); None: the block layout is not
# checked (the shape's warp verdict dates from before the block layout).
@pytest.mark.parametrize("S,H,N,warp,block", [
    _budget_case(1, 1, True, None), _budget_case(5, 20, True, None),
    _budget_case(5, 30, True, None), _budget_case(5, 33, True, None),
    _budget_case(16, 32, True, None), _budget_case(8, 64, True, None),
    _budget_case(4, 128, True, None), _budget_case(20, 30, False, None),
    _budget_case(5, 129, False, None), _budget_case(8, 96, False, None),
    _budget_case(0, 10, False, None),
    # The block layout: the path's H=20, the bench's long and assets500
    # shapes, the edges past the warp budget, 16 scenarios at H=20, and
    # the largest shapes kmpc_tpu's kernel admits at one forecast.
    _budget_case(20, 20, False, True), _budget_case(20, 30, False, True),
    _budget_case(5, 500, False, True), _budget_case(17, 20, False, True),
    _budget_case(5, 129, False, True), _budget_case(3, 150, False, True),
    _budget_case(20, 20, False, True, S=16),
    _budget_case(1, 2730, False, True),
    _budget_case(20, 136, False, True), _budget_case(5, 546, False, True),
    # Beyond a block's shared memory.
    _budget_case(20, 600, False, False), _budget_case(1, 12000, False, False),
    _budget_case(64, 128, False, False, S=16),
    _budget_case(0, 10, False, False),
])
def test_kernel_register_budget(S, H, N, warp, block):
    """The warp layout's register budget (``kernel_supports``) and the
    block layout's shared-memory budget (``block_kernel_supports``); the
    layout a CUDA solve takes follows from both and from the row layout's
    budget (``rows_kernel_supports``), which routing prefers: up to 32 rows
    of 128 assets."""
    assert M.kernel_supports(H, N) is warp
    if block is None:
        return
    fits = M.block_kernel_supports(S, H, N)
    assert fits is block
    assert fits == (M.block_smem_bytes(S, H, N) <= M.SMEM_PER_BLOCK
                    and H >= 1)
    rows = M.rows_kernel_supports(S, H, N)
    want = "rows" if rows else (
        "warp" if warp else ("block" if block else None))
    assert M.kernel_layout(S, H, N) == want


def test_allow_short_is_solved_by_the_eager_solver_by_name():
    """allow_short needs the hyperplane projection, which the kernel lacks:
    the packed wrapper raises, and the eager solver, called by name, gives
    the solution that kmpc_tpu's wrapper returns for the parameter (it
    hands the solve to its own eager solver). Weights atol 2e-5, objective
    atol 1e-5."""
    from kmpc_tpu.ops.mpc_pallas import solve_mpc_log_utility_pallas_packed
    from kmpc_tpu_torch.ops.mpc import solve_mpc_log_utility_batch

    cw, ys = _instance(6, 5, 10, seed=3)
    kw = dict(max_iters=400, allow_short=True)
    with pytest.raises(NotImplementedError, match="eager"):
        M.solve_mpc_log_utility_packed(
            torch.as_tensor(cw), torch.as_tensor(ys), _params(kw),
            device="cpu")
    w, info = solve_mpc_log_utility_batch(torch.as_tensor(cw),
                                          torch.as_tensor(ys), _params(kw))
    assert w.min().item() < -1e-6
    w_j, info_j = solve_mpc_log_utility_pallas_packed(
        jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams))
    assert set(info_j) <= set(info)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               np.asarray(info_j["objective"]), atol=OBJ_TOL,
                               rtol=0)


@pytest.mark.parametrize("field,value,exc", [
    ("allow_short", True, NotImplementedError),
    ("polish", True, ValueError),
])
def test_unported_parameters_raise(field, value, exc):
    cw, ys = _instance(3, 5, 20, seed=0)
    p = dataclasses.replace(MPCParams(max_iters=10), **{field: value})
    with pytest.raises(exc):
        M.solve_mpc_log_utility_packed(torch.as_tensor(cw),
                                       torch.as_tensor(ys), p, device="cpu")


def test_pipelined_body_raises():
    """The pipelined body (``pipeline_reduces`` with a refresh schedule),
    which raised here until it was ported, raises no more: at H=5, N=20 the
    packed solve on the CPU meets the bars against kmpc_tpu's Pallas kernel
    (``make_trip_pipe``) in interpret mode."""
    from kmpc_tpu.ops.mpc_pallas import solve_mpc_log_utility_pallas_packed

    cw, ys = _instance(6, 5, 20, seed=0)
    kw = dict(max_iters=300, proj_refresh_every=16, pipeline_reduces=True,
              precond=True)
    w_j, info_j = solve_mpc_log_utility_pallas_packed(
        jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams), tile_b=128,
        interpret=True)
    w, info = M.solve_mpc_log_utility_packed(
        torch.as_tensor(cw), torch.as_tensor(ys), _params(kw), device="cpu")
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               np.asarray(info_j["objective"]), atol=OBJ_TOL,
                               rtol=0)
    assert M._pipelined(_params(kw))
    assert not M._pipelined(_params(dict(kw, adaptive=True)))
    assert not M._pipelined(_params(dict(kw, proj_warm_iters=0)))


# ---------------------------------------------------------------------------
# The pieces around the kernel, each against its kmpc_tpu counterpart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 20, 33, 70, 300])
@pytest.mark.parametrize("warm", [False, True])
def test_simplex_threshold_matches(n, warm):
    from kmpc_tpu.ops.projections import _simplex_threshold
    from kmpc_tpu_torch.ops.projections import simplex_threshold

    rng = np.random.default_rng(n)
    v = (rng.standard_normal((4, 3, n)) * 0.3).astype(np.float32)
    th0 = (rng.standard_normal((4, 3, 1)) * 0.05).astype(np.float32) \
        if warm else None
    iters = 3 if warm else None
    want = np.asarray(_simplex_threshold(
        jnp.asarray(v), 1.0, iters, None if th0 is None else jnp.asarray(th0)))
    got = simplex_threshold(torch.as_tensor(v), 1.0, iters,
                            None if th0 is None else torch.as_tensor(th0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [5, 20, 33])
def test_kernel_thresholds_match_packed_threshold(n):
    """The cold start and the sweeps of the plain version against the TPU
    kernel's ``_packed_threshold`` and ``_ball_l1_and_sweep`` (asset axis
    second to last, problems on the last axis there)."""
    from kmpc_tpu.ops.mpc_pallas import _ball_l1_and_sweep, _packed_threshold
    from kmpc_tpu_torch.ops.projections import (
        ball_l1_and_sweep, michelot_threshold,
    )

    rng = np.random.default_rng(n)
    v = (rng.standard_normal((3, 6, n)) * 0.2).astype(np.float32)   # [H,B,N]
    a = np.abs(v)
    vt = jnp.asarray(np.transpose(v, (0, 2, 1)))                    # [H,N,B]
    th_cold = np.asarray(_packed_threshold(vt, 1.0, 5, n_valid=float(n)))
    got = michelot_threshold(torch.as_tensor(v), 1.0, 5)
    np.testing.assert_allclose(got.numpy(), np.transpose(th_cold, (0, 2, 1)),
                               atol=1e-6, rtol=0)
    th0 = np.full((3, 1, 6), 0.01, np.float32)
    at = jnp.asarray(np.transpose(a, (0, 2, 1)))
    l1_j, th_j = _ball_l1_and_sweep(at, at, 0.3, jnp.asarray(th0))
    l1_t, th_t = ball_l1_and_sweep(torch.as_tensor(a), 0.3,
                                   torch.as_tensor(np.transpose(th0, (0, 2, 1))))
    np.testing.assert_allclose(l1_t.numpy(),
                               np.transpose(np.asarray(l1_j), (0, 2, 1)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(th_t.numpy(),
                               np.transpose(np.asarray(th_j), (0, 2, 1)),
                               atol=1e-6, rtol=0)


def test_restore_turnover_feasibility_matches():
    from kmpc_tpu.ops.mpc import restore_turnover_feasibility as j
    from kmpc_tpu_torch.ops.mpc import restore_turnover_feasibility as t

    rng = np.random.default_rng(0)
    w = rng.dirichlet(np.ones(9), size=(6, 4)).astype(np.float32)
    cw = rng.dirichlet(np.ones(9), size=6).astype(np.float32)
    want = np.asarray(j(jnp.asarray(w), jnp.asarray(cw), 0.2))
    got = t(torch.as_tensor(w), torch.as_tensor(cw), 0.2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_objective_and_status_match():
    from kmpc_tpu.ops.mpc import _log_utility_objective as jobj
    from kmpc_tpu.ops.mpc import _status_code as jstat
    from kmpc_tpu_torch.ops.mpc import _log_utility_objective, _status_code

    rng = np.random.default_rng(1)
    w = rng.dirichlet(np.ones(9), size=(6, 4)).astype(np.float32)
    r = np.exp(rng.standard_normal((6, 4, 9)) * 0.01).astype(np.float32)
    cw = rng.dirichlet(np.ones(9), size=6).astype(np.float32)
    want = np.asarray(jobj(jnp.asarray(w), jnp.asarray(r), jnp.asarray(cw),
                           0.001))
    got = _log_utility_objective(torch.as_tensor(w), torch.as_tensor(r),
                                 torch.as_tensor(cw), 0.001).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    fp = np.array([0.0, 1e-5, 2e-5, np.inf, np.nan, 1.0], np.float32)
    np.testing.assert_array_equal(
        _status_code(torch.as_tensor(fp), 1e-5).numpy(),
        np.asarray(jstat(jnp.asarray(fp), 1e-5)))


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("H", [1, 5])
def test_pdhg_steps_match(precond, H):
    from kmpc_tpu.ops.mpc import _pdhg_steps as j
    from kmpc_tpu_torch.ops.mpc import _pdhg_steps as t

    Lt = np.random.default_rng(H).uniform(10, 40, size=(4, H)).astype(
        np.float32)
    tj, sj = j(jnp.asarray(Lt), JParams(precond=precond, sigma_scale=2.0))
    tt, st = t(torch.as_tensor(Lt), MPCParams(precond=precond,
                                              sigma_scale=2.0))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6)
    np.testing.assert_allclose(
        np.broadcast_to(st.numpy(), np.broadcast_shapes(st.shape, sj.shape)),
        np.broadcast_to(np.asarray(sj),
                        np.broadcast_shapes(st.shape, sj.shape)), rtol=1e-6)
