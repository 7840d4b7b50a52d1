"""The port's float64 verification path (ops/mpc_polish.py) against
kmpc_tpu's, and against the certified records in parity_cache/.

The same numpy inputs go through kmpc_tpu's functions (float64 under
``jax.enable_x64``, on the CPU) and the port's. Tolerances, each stated at
its test: the Jacobians within 1e-12 of jacfwd and of kmpc_tpu's, the
polish's residuals and weights within 1e-10, the host stages (numpy on
both sides) at rounding level, the longdouble helpers bit for bit, and the
cached certificates within 1e-7 of parity_cache/polish_random.jsonl.
kmpc_tpu's whole pipeline compiles float64 programs for minutes on the
CPU, so the case that runs it is marked slow. Torch runs on one thread.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

JAC_TOL = 1e-12          # dense Jacobians: jacfwd, kmpc_tpu's, the port's
POLISH_TOL = 1e-10       # polish_log_utility's residuals and weights
HOST_TOL = 1e-12         # numpy host stages, the same code in both packages
CERT = 1e-10             # a certificate: fixed-point residual below this
RECORD_W_TOL = 1e-7      # a certified point against its record


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x64():
    """kmpc_tpu's functions in float64 on the CPU."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


def _params(pkg, **kw):
    from kmpc_tpu.ops.mpc import MPCParams as JP
    from kmpc_tpu_torch.ops.mpc import MPCParams as TP

    return (JP if pkg == "jax" else TP)(**kw)


def _instance(seed, B, H, N, scale=0.01, drift=1e-3):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B)
    y = rng.standard_normal((B, H, N)) * scale + drift
    return cw, y


def _pdhg64(cw, y, iters, **kw):
    """The port's eager solve in float64 on the CPU: (w, p) numpy."""
    from kmpc_tpu_torch.ops.mpc import solve_mpc_log_utility_batch

    p = _params("torch", max_iters=iters, sigma_scale=2.0, **kw)
    w, info = solve_mpc_log_utility_batch(torch.tensor(cw), torch.tensor(y),
                                          p)
    return w.numpy(), info["dual"].numpy()


def test_masks_and_dense_jacobian_match_jacfwd_and_kmpc_tpu():
    """At a PDHG iterate (H=3, N=6, float64): the port's projection and
    dual-prox masks equal kmpc_tpu's, and its assembled dense J equals
    ``torch.func.jacfwd`` of its residual map and kmpc_tpu's J (its
    components applied to the identity, as tests/test_mpc_polish.py
    builds it) within JAC_TOL."""
    from kmpc_tpu.ops import mpc as JM
    from kmpc_tpu.ops import mpc_polish as JMP
    from kmpc_tpu_torch.ops import mpc_polish as TMP
    from kmpc_tpu_torch.ops.mpc import _apply_D, _apply_Dt

    H, N = 3, 6
    m = H * N
    cw, y = _instance(0, 1, H, N)
    cw, y = cw[0], y[0]
    kw = dict(restore_feasibility=False)
    w1, p1 = (a[0] for a in _pdhg64(cw[None], y[None], 3000, **kw))
    params = _params("torch", max_iters=3000, sigma_scale=2.0, **kw)

    r = torch.exp(torch.tensor(y))
    w_init = torch.tensor(cw)
    tau, sigma = TMP._fixed_point_steps(r, params)
    c, tau_to = params.cost_coeff, params.max_turnover

    def rvec(x):
        w, p = x[:m].reshape(H, N), x[m:].reshape(H, N)
        Rw, Rp, _ = TMP._residual_and_margins(w, p, r, w_init, tau, sigma,
                                              params)
        return torch.cat([Rw.reshape(-1), Rp.reshape(-1)])

    x0 = torch.cat([torch.tensor(w1).reshape(-1),
                    torch.tensor(p1).reshape(-1)])
    J_auto = torch.func.jacfwd(rvec)(x0).numpy()
    w, p = torch.tensor(w1), torch.tensor(p1)
    _, _, margins = TMP._residual_and_margins(w, p, r, w_init, tau, sigma,
                                              params)
    masks = TMP._masks_from_margins(margins, 0.0, tau_to)
    J_port = TMP._dense_jacobian(masks, r, tau, sigma, params.ridge).numpy()
    assert np.abs(J_port - J_auto).max() < JAC_TOL

    # The masks against kmpc_tpu's, at the same points.
    port = (w * r).sum(-1, keepdim=True)
    vw = w - tau * (-r / port + _apply_Dt(p))
    vp = p + sigma * _apply_D(w, w_init)
    _, a_t = TMP._proj_simplex_with_jac(vw)
    q_t = TMP._Q_with_jac(vp, sigma, c, tau_to)
    with _x64():
        rj, cj = jnp.exp(jnp.asarray(y)), jnp.asarray(cw)
        vwj, vpj = jnp.asarray(vw.numpy()), jnp.asarray(vp.numpy())
        sj, tj = float(sigma), float(tau)
        _, a_j = JMP._proj_simplex_with_jac(vwj)
        q_j = JMP._Q_with_jac(vpj, sj, c, tau_to)
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        for x_t, x_j in zip(q_t[1:], q_j[1:]):
            np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
        np.testing.assert_allclose(q_t[0].numpy(), np.asarray(q_j[0]),
                                   atol=JAC_TOL, rtol=0)

        # kmpc_tpu's J, as its own test assembles it.
        w1j, p1j = jnp.asarray(w1), jnp.asarray(p1)
        portj = jnp.sum(w1j * rj, -1, keepdims=True)
        _, s, act, sgn, outside = JMP._Q_with_jac(
            p1j + sj * JM._apply_D(w1j, cj), sj, c, tau_to)
        _, a = JMP._proj_simplex_with_jac(
            w1j - tj * (-rj / portj + JM._apply_Dt(p1j)))

        def japply(xw, xp):
            coeff = jnp.sum(rj * xw, -1, keepdims=True) / portj ** 2
            dvw = xw - tj * (rj * coeff + JM._apply_Dt(xp))
            Jw = xw - JMP._apply_P_jac(a, dvw)
            dvp = xp + sj * JM._apply_D(xw, jnp.zeros_like(cj))
            Jp = xp - (dvp - JMP._apply_B_jac(s, act, sgn, outside, dvp))
            return jnp.concatenate([Jw.ravel(), Jp.ravel()])

        eye = np.eye(2 * m)
        J_jax = np.asarray(jnp.stack(
            [japply(jnp.asarray(eye[k, :m].reshape(H, N)),
                    jnp.asarray(eye[k, m:].reshape(H, N)))
             for k in range(2 * m)], 1))
    assert np.abs(J_port - J_jax).max() < JAC_TOL


@pytest.mark.parametrize("kink_aware", [
    False, pytest.param(True, marks=pytest.mark.slow)])
def test_polish_log_utility_matches_kmpc_tpu(kink_aware):
    """One polish from the same float64 PDHG iterate (B=4, H=3, N=6): the
    damped semismooth-Newton rounds alone, and (slow: kmpc_tpu's side took
    58-79 s on a CPU, compiling its float64 programs op by op) with the
    kink-aware machinery (the active-set Newton, the EXPAND / SHRINK
    elements, the min-norm step). Residuals before and after, the accepted
    mask and the weights within POLISH_TOL. The duals are not compared: on
    the KKT system's dual null directions two exact certificates may
    differ (measured 6e-8 apart with residuals of 1e-16 on both sides)."""
    from kmpc_tpu.ops import mpc_polish as JMP
    from kmpc_tpu_torch.ops import mpc_polish as TMP

    cw, y = _instance(0, 4, 3, 6)
    kw = dict(max_iters=800, sigma_scale=2.0, ridge=1e-3)
    w, p = _pdhg64(cw, y, 800, ridge=1e-3)
    wt, it = TMP.polish_log_utility(torch.tensor(w), torch.tensor(p),
                                    torch.tensor(cw), torch.tensor(y),
                                    _params("torch", **kw),
                                    kink_aware=kink_aware)
    with _x64():
        wj, ij = JMP.polish_log_utility(
            jnp.asarray(w), jnp.asarray(p), jnp.asarray(cw), jnp.asarray(y),
            _params("jax", **kw), kink_aware=kink_aware)
        wj = np.asarray(wj)
        ij = {k: np.asarray(v) for k, v in ij.items()}
    for key in ("residual_before", "residual_after"):
        np.testing.assert_allclose(it[key].numpy(), ij[key],
                                   atol=POLISH_TOL, rtol=0)
    np.testing.assert_array_equal(it["accepted"].numpy(), ij["accepted"])
    assert it["accepted"].any()
    if kink_aware:
        assert not it["accepted"].all()
        assert (it["residual_after"][it["accepted"]] < CERT).all()
    np.testing.assert_allclose(wt.numpy(), wj, atol=POLISH_TOL, rtol=0)
    np.testing.assert_allclose(it["w_iterate"].numpy(), ij["w_iterate"],
                               atol=POLISH_TOL, rtol=0)


# The inputs of tests/test_mpc_polish.py's boundary-refinement (seed 17)
# and interior-point (seed 9) cases: H=3, N=8, returns 0.02 N(0, 1).
def _refine_case(seed):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(8))
    y = rng.standard_normal((3, 8)) * 0.02
    return cw, y


@pytest.mark.parametrize("seed", [17, 9])
def test_interior_point_instance_matches_kmpc_tpu(seed):
    """The host barrier solve (numpy in both packages) gives kmpc_tpu's
    point within HOST_TOL, feasible, and the port's polish certifies from
    it."""
    from kmpc_tpu.ops import mpc_polish as JMP
    from kmpc_tpu_torch.ops import mpc_polish as TMP

    cw, y = _refine_case(seed)
    kw = dict(max_iters=20000, sigma_scale=2.0, ridge=1e-3)
    w_t, q_t = TMP._interior_point_instance(cw, y, _params("torch", **kw))
    with _x64():
        w_j, q_j = JMP._interior_point_instance(cw, y, _params("jax", **kw))
    np.testing.assert_allclose(w_t, w_j, atol=HOST_TOL, rtol=0)
    np.testing.assert_allclose(q_t, q_j, atol=HOST_TOL, rtol=0)
    assert np.allclose(w_t.sum(-1), 1.0, atol=1e-9) and w_t.min() > -1e-12
    u = w_t - np.vstack([cw[None], w_t[:-1]])
    assert np.all(np.abs(u).sum(-1) <= 0.2 + 1e-9)
    _, info = TMP.polish_log_utility(
        torch.tensor(w_t[None]), torch.tensor(q_t[None]),
        torch.tensor(cw[None]), torch.tensor(y[None]),
        _params("torch", **kw))
    assert float(info["residual_after"][0]) < CERT


def _pattern(w0, cw, tau_to):
    """The active pattern read off a certified solve, as
    tests/test_mpc_polish.py reads it."""
    u0 = w0 - np.vstack([cw[None], w0[:-1]])
    S = (w0 > 1e-9).astype(float)
    prev_sup = np.vstack([(cw > 1e-14)[None].astype(float), S[:-1]])
    f_leave = (S == 0) & (prev_sup > 0)
    f_enter = (S > 0) & (prev_sup == 0)
    A = ((np.abs(u0) > 1e-6) | f_leave | f_enter).astype(float)
    sgn = np.where(np.abs(u0) > 1e-6, np.sign(u0),
                   np.where(f_enter, 1.0, -1.0)) * A
    Bm = (np.abs(u0).sum(-1) >= tau_to * (1 - 1e-3)).astype(float)
    return S, A, sgn, Bm


def test_boundary_refinement_components_match_kmpc_tpu():
    """On the seed-17 instance: the restricted primal Newton (torch jacfwd
    against jax jacfwd) reproduces the certified weights in both packages
    within HOST_TOL of each other; the dual LP and the pair residual (the
    same numpy / HiGHS inputs) agree within HOST_TOL; and the whole
    per-instance refinement from an uncertified iterate gives kmpc_tpu's
    residual class and weights within RECORD_W_TOL."""
    from kmpc_tpu.ops import mpc_polish as JMP
    from kmpc_tpu_torch.ops import mpc_polish as TMP

    cw, y = _refine_case(17)
    r = np.exp(y)
    kw = dict(max_iters=4000, sigma_scale=2.0, ridge=1e-3)
    pt, pj = _params("torch", **kw), _params("jax", **kw)
    w, info = TMP.solve_mpc_log_utility_batch_polished(
        torch.tensor(cw[None], dtype=torch.float32),
        torch.tensor(y[None], dtype=torch.float32),
        dataclasses.replace(pt, polish=True))
    assert float(info["residual_after"][0]) < CERT
    w0 = w[0].numpy()
    S, A, sgn, Bm = _pattern(w0, cw, pt.max_turnover)

    wf_t, f_t = TMP._solve_restricted_primal(w0, cw, r, S, A, sgn, Bm, pt)
    with _x64():
        wf_j, f_j = JMP._solve_restricted_primal(w0, cw, r, S, A, sgn, Bm,
                                                 pj)
        assert f_t < CERT and f_j < CERT
        np.testing.assert_allclose(wf_t, wf_j, atol=HOST_TOL, rtol=0)
        assert np.abs(wf_t - w0).max() < 1e-6
        gradf = (-r / np.maximum((wf_j * r).sum(-1, keepdims=True), 1e-12)
                 + pt.ridge * wf_j)
        q_t, s_t = TMP._dual_slack_lp(gradf, S, A, sgn, Bm, pt.cost_coeff)
        q_j, s_j = JMP._dual_slack_lp(gradf, S, A, sgn, Bm, pt.cost_coeff)
        np.testing.assert_allclose(q_t, q_j, atol=HOST_TOL, rtol=0)
        assert s_t == pytest.approx(s_j, abs=HOST_TOL) and s_t >= -1e-12
        wpos = np.maximum(wf_j, 0.0)
        rr_t = TMP._pair_residual(wpos, q_t, r, cw, pt)
        rr_j = JMP._pair_residual(wpos, q_t, r, cw, pj)
        assert rr_t == pytest.approx(rr_j, abs=HOST_TOL) and rr_t < 1e-9

        # The whole refinement from a PDHG iterate 1500 iterations in.
        w1, p1 = (a[0] for a in _pdhg64(cw[None], y[None], 1500,
                                         ridge=1e-3))
        out_t = TMP._boundary_refine_instance(w1, p1, cw, y, pt)
        out_j = JMP._boundary_refine_instance(w1, p1, cw, y, pj)
    assert (out_t is None) == (out_j is None)
    if out_t is not None:
        assert (out_t[2] < CERT) == (out_j[2] < CERT)
        if out_t[2] < CERT:
            np.testing.assert_allclose(out_t[0], out_j[0],
                                       atol=RECORD_W_TOL, rtol=0)


def test_longdouble_helpers_bit_for_bit():
    """The extended-precision stage is numpy longdouble in both packages:
    the threshold, the LU solve and the whole per-instance polish give the
    same bits."""
    from kmpc_tpu.ops import mpc_polish as JMP
    from kmpc_tpu_torch.ops import mpc_polish as TMP

    rng = np.random.default_rng(5)
    ld = np.longdouble
    v = rng.standard_normal((4, 3, 17)).astype(ld)
    for radius in (ld(1), ld(0.2)):
        np.testing.assert_array_equal(TMP._ld_simplex_threshold(v, radius),
                                      JMP._ld_simplex_threshold(v, radius))
    A = rng.standard_normal((24, 24)).astype(ld)
    A[3] = 0                               # a zero pivot on the way
    A[3, 5] = 1e-30
    b = rng.standard_normal(24).astype(ld)
    np.testing.assert_array_equal(TMP._ld_lu_solve(A, b),
                                  JMP._ld_lu_solve(A, b))

    cw, y = _instance(3, 1, 2, 5, scale=0.005, drift=0.0)
    w, p = (a[0] for a in _pdhg64(cw, y, 300, ridge=1e-3))
    kw = dict(max_iters=300, sigma_scale=2.0, ridge=1e-3)
    out_t = TMP._extended_polish_instance(w, p, cw[0], y[0],
                                          _params("torch", **kw), rounds=4)
    out_j = JMP._extended_polish_instance(w, p, cw[0], y[0],
                                          _params("jax", **kw), rounds=4)
    for a_t, a_j in zip(out_t, out_j):
        np.testing.assert_array_equal(a_t, a_j)


@pytest.mark.slow
def test_batch_polished_matches_kmpc_tpu():
    """The whole pipeline in both packages (H=2 N=5 and H=3 N=6): the same
    certified set and, where certified, weights within RECORD_W_TOL (the
    ridge makes each optimum unique). Slow: kmpc_tpu's side compiles its
    float64 programs for minutes on the CPU."""
    from kmpc_tpu.ops import mpc_polish as JMP
    from kmpc_tpu_torch.ops import mpc_polish as TMP

    for seed, (H, N) in enumerate(((2, 5), (3, 6))):
        cw, y = _instance(seed, 4, H, N)
        kw = dict(max_iters=3000, sigma_scale=2.0, ridge=1e-3, polish=True)
        cw32, y32 = cw.astype(np.float32), y.astype(np.float32)
        wt, it = TMP.solve_mpc_log_utility_batch_polished(
            torch.tensor(cw32), torch.tensor(y32), _params("torch", **kw))
        wj, ij = JMP.solve_mpc_log_utility_batch_polished(
            jnp.asarray(cw32), jnp.asarray(y32), _params("jax", **kw))
        rt = it["residual_after"].numpy()
        rj = np.asarray(ij["residual_after"])
        np.testing.assert_array_equal(rt < CERT, rj < CERT)
        both = (rt < CERT) & (rj < CERT)
        assert np.abs(wt.numpy() - np.asarray(wj))[both].max() \
            < RECORD_W_TOL


def test_cached_random_certificates_without_jax():
    """The port's verified path on the CPU, on the first 8 instances of
    ``polish_order`` of the random family (H=5, N=30), at the records'
    settings (ridge 1e-3, sigma_scale 2, 3 cycles, 4 Newton steps, 30000
    first-solve iterations): every instance certified (residual < CERT)
    and within RECORD_W_TOL of parity_cache/polish_random.jsonl."""
    from kmpc_tpu_torch.ops.mpc_polish import (
        solve_mpc_log_utility_batch_polished,
    )
    from kmpc_tpu_torch.parity_cdf import REPO_CACHE, polish_order

    d = np.load(REPO_CACHE / "instances_random_1000.npz")
    recs = {}
    for line in open(REPO_CACHE / "polish_random.jsonl"):
        rec = json.loads(line)
        recs[rec["idx"]] = rec
    ids = polish_order(1000)[:8]
    params = _params("torch", max_iters=30000, sigma_scale=2.0, ridge=1e-3,
                     polish=True, polish_newton=4)
    w, info = solve_mpc_log_utility_batch_polished(
        torch.tensor(d["cw"][ids]), torch.tensor(d["ys"][ids]), params,
        cycles=3)
    assert w.dtype == torch.float64
    res = info["residual_after"].numpy()
    assert (res < CERT).all(), res
    ref = np.stack([np.asarray(recs[i]["w"]).reshape(5, 30) for i in ids])
    assert np.abs(w.numpy() - ref).max() < RECORD_W_TOL


def test_polish_wiring_config_to_solver():
    """``MPC.SOLVER.POLISH=True`` reaches the single-problem solver through
    ``mpc_params_from_config``: the polished path runs (kmpc_tpu's keys, as
    tests/test_mpc_polish.py checks them), changes the result, and its
    batched info describes the polished float64 iterate. The batch solvers
    still refuse the flag and name the entries that run it. Ridge 1e-3:
    each instance's optimum is unique, and the main cycles certify it."""
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.ops.mpc import (
        mpc_params_from_config,
        solve_mpc_log_utility,
        solve_mpc_log_utility_batch,
    )
    from kmpc_tpu_torch.ops.mpc_polish import (
        solve_mpc_log_utility_batch_polished,
    )

    cfg = get_config("finance_sparse")
    cfg.MPC.SOLVER.POLISH = True
    cfg.MPC.SOLVER.POLISH_NEWTON = 4
    params = mpc_params_from_config(cfg, max_iters=3000, sigma_scale=2.0,
                                    ridge=1e-3, restore_feasibility=False)
    assert params.polish and params.polish_newton == 4

    cw, y = _instance(0, 8, 3, 6)
    cw, y = cw.astype(np.float32), y.astype(np.float32)
    w_pol, info = solve_mpc_log_utility_batch_polished(
        torch.tensor(cw), torch.tensor(y), params)
    assert w_pol.dtype == torch.float64
    rb, ra = info["residual_before"].numpy(), info["residual_after"].numpy()
    acc = info["accepted"].numpy()
    assert acc.any()
    assert np.all(ra[acc] < CERT) and np.all(ra <= rb + 1e-12)
    np.testing.assert_allclose(w_pol.sum(-1).numpy(), 1.0, atol=1e-9)
    assert info["dual"].dtype == torch.float64
    assert info["turnover_violation"].dtype == torch.float64
    assert info["converged"].dtype == torch.bool

    k = int(np.flatnonzero(acc)[0])
    w1, stats = solve_mpc_log_utility(cw[k], y[k], params, device="cpu")
    assert {"status", "value", "turnover_violation", "polish_residual_before",
            "polish_residual_after", "polish_accepted"} == set(stats)
    assert stats["polish_accepted"] and stats["polish_residual_after"] < CERT
    assert stats["status"] == "optimal"
    w0, stats0 = solve_mpc_log_utility(
        cw[k], y[k], dataclasses.replace(params, polish=False), device="cpu")
    assert "polish_residual_after" not in stats0
    assert not np.array_equal(w1, w0)

    with pytest.raises(ValueError,
                       match="solve_mpc_log_utility_batch_polished"):
        solve_mpc_log_utility_batch(torch.tensor(cw), torch.tensor(y), params)


def test_polished_output_is_feasible_and_its_info_recomputed():
    """With ``restore_feasibility`` the returned float64 weights meet the
    turnover cap and the simplex exactly, ``converged`` is the polished
    iterate's, and the status bands on ``residual_after``."""
    from kmpc_tpu_torch.ops.mpc import STATUS_OPTIMAL
    from kmpc_tpu_torch.ops.mpc_polish import (
        solve_mpc_log_utility_batch_polished,
    )

    cw, y = _instance(3, 6, 3, 6)
    cw, y = cw.astype(np.float32), y.astype(np.float32)
    params = _params("torch", max_iters=3000, sigma_scale=2.0, ridge=1e-3,
                     polish=True, restore_feasibility=True)
    w, info = solve_mpc_log_utility_batch_polished(torch.tensor(cw),
                                                   torch.tensor(y), params)
    w = w.numpy()
    u = w - np.concatenate([cw.astype(np.float64)[:, None], w[:, :-1]], 1)
    assert np.all(np.abs(u).sum(-1) <= params.max_turnover + 1e-9)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-9)
    assert w.min() >= -1e-12
    assert info["converged"].all()
    assert (info["status_code"] == STATUS_OPTIMAL).all()
    assert info["w_iterate"].shape == w.shape
    assert info["fixed_point_residual"].dtype == torch.float32  # first solve
