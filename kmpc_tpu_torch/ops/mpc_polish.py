"""Semismooth-Newton polish for the log-utility MPC solver: the float64
verification path (``MPCParams.polish``).

Port of kmpc_tpu/ops/mpc_polish.py. First-order (PDHG) iterations identify
the optimal active sets quickly but crawl along the nearly-flat faces of
this LP-like objective. Once PDHG is in the right neighbourhood, a few
damped semismooth-Newton steps on the PDHG fixed-point residual converge
superlinearly to machine-precision KKT points.

Residual map (non-extrapolated PDHG fixed point; zero exactly at the
saddle point):

    R_w(w, p) = w - P( w - tau (grad g(w) + D' p) )
    R_p(w, p) = p - Q( p + sigma (D w - b) )

with P = simplex projection (per horizon row) and
Q(q) = q - sigma * B(q / sigma),
B = proj_{l1-ball(tau_to)} o shrink_{c/sigma}.

Generalized Jacobians (all per-row diag +/- rank-1):

    P'(v)  = diag(a) - a a' / |a|             a = active mask of the projection
    shrink'= diag(s)                          s = |u| > c/sigma
    ball'  = I (inside) or diag(act) - (sgn act)(sgn act)'/|act| (outside)
    Q'     = I - ball' . shrink'

The full Jacobian is a dense [2HN, 2HN] matrix per problem, assembled
batched by applying its action to the identity. In float32 the KKT system
is too ill-conditioned for a useful step (the acceptance test then rejects
every step, so the polish is a no-op); the verified path runs it in
float64.

Where it runs. The first solve runs in the caller's dtype on the caller's
device (the eager solver of ops/mpc.py). An H100 does float64 natively, so
every batched float64 stage runs on that same device: the PDHG <-> Newton
cycles, the dense Jacobians and their LU solves and SVDs, the warm PDHG
continuations, and the loop over the uncertified subset. The per-instance
stages that are host algorithms stay numpy and scipy on the host: the
boundary refinement with its LPs, the interior-point fallback, and the
extended-precision (``numpy.longdouble``) stage, which has no counterpart
on a GPU. Every minimum-norm step is an explicit SVD pseudo-inverse, on
every device, so that the card and the CPU take the same step
(``torch.linalg.lstsq`` on CUDA has only the full-rank ``gels`` driver,
and the no-trade dates make J structurally singular).

kmpc_tpu's ``_ld_pdhg_continue`` is not ported: nothing calls it.
"""

from __future__ import annotations

import contextlib
import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from functools import lru_cache
from itertools import product
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from kmpc_tpu_torch.ops.mpc import (
    MPCParams,
    _apply_D,
    _apply_Dt,
    _log_utility_objective,
    _status_code,
    graph_replayed,
    restore_turnover_feasibility,
    solve_mpc_log_utility_batch,
)
from kmpc_tpu_torch.ops.projections import simplex_threshold

# Iterations a CUDA graph of the eager PDHG loop holds on a card (times the
# solve's ``adapt_every``): the first solve and the continuations replay it
# instead of launching each operation from the host.
GRAPH_CHUNK = 100

def _stage(timer, name: str, tree=None):
    """``timer.stage(name, tree)`` (a ``utils.profiler.StageTimer``, which
    synchronises the tensors' device at the stage's end), or nothing when
    the caller passed no timer."""
    return timer.stage(name, tree) if timer is not None \
        else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Projections, kink margins and generalized Jacobians
# ---------------------------------------------------------------------------


def _proj_simplex_with_jac(v):
    """Simplex projection per trailing row + its generalized Jacobian.

    v: [..., H, N] -> (P(v) [..., H, N], active mask a [..., H, N]).
    Jacobian action: J_P x = a*x - a * (a.x)/|a|.
    """
    theta = simplex_threshold(v, 1.0)
    w = torch.clamp(v - theta, min=0.0)
    active = (v - theta > 0.0).to(v.dtype)
    return w, active


def _proj_simplex_with_margin(v):
    """Simplex projection + per-component kink margin v - theta.

    The generalized Jacobian's active set is ``margin > 0``; components
    with |margin| ~ 0 sit AT the projection kink, where the
    B-subdifferential contains both the include and exclude elements
    (the kink-aware Newton tries both sides, see polish_log_utility).
    """
    theta = simplex_threshold(v, 1.0)
    return torch.clamp(v - theta, min=0.0), v - theta


def _apply_P_jac(active, x):
    """Apply P'(v) = diag(a) - a a'/|a| row-wise to x [..., H, N]."""
    cnt = torch.clamp(active.sum(dim=-1, keepdim=True), min=1.0)
    ax = active * x
    return ax - active * (ax.sum(dim=-1, keepdim=True) / cnt)


def _Q_with_margins(q, sigma, c, tau_to):
    """Dual prox Q(q) + the kink margins that define its generalized
    Jacobian (see the module docstring).

    Returns ``(Q, margins)`` with margins = dict(ms, ma, mo, dir):
        ms  [..., H, N]  shrink margin |u| - c/sigma (kink at 0)
        ma  [..., H, N]  ball active-set margin a - theta (kink at 0)
        mo  [..., H, 1]  ball boundary margin l1 - tau_to (kink at 0)
        dir [..., H, N]  rank-1 direction: sign(y), falling back to
                         sign(u) exactly at the shrink kink (y == 0)
    The nominal Jacobian masks are ``margin > 0`` (see _dual_masks);
    flipping components with |margin| <= eps selects a different, equally
    valid, element of the B-subdifferential at the kink.
    """
    u = q / sigma
    ms = u.abs() - c / sigma
    y = torch.sign(u) * torch.clamp(ms, min=0.0)
    if tau_to > 0:
        a = y.abs()
        l1 = a.sum(dim=-1, keepdim=True)
        theta = torch.clamp(simplex_threshold(a, tau_to), min=0.0)
        ma = a - theta
        mo = l1 - tau_to
        z = torch.where(mo > 0, torch.sign(y) * torch.clamp(ma, min=0.0), y)
    else:
        ma = ms
        mo = torch.full_like(q[..., :1], -1.0)  # never outside
        z = y
    Q = q - sigma * z
    dir_ = torch.where(y != 0, torch.sign(y), torch.sign(u))
    return Q, {"ms": ms, "ma": ma, "mo": mo, "dir": dir_}


def _Q_with_jac(q, sigma, c, tau_to):
    """Dual prox Q(q) and the NOMINAL (one-sided, eps=0) Jacobian masks
    (s, act, sgn, outside); see _Q_with_margins / _dual_masks for the
    kink-aware elements."""
    Q, margins = _Q_with_margins(q, sigma, c, tau_to)
    s, act, sgn, outside = _dual_masks(margins, 0.0, tau_to)
    return Q, s, act, sgn, outside


def _dual_masks(margins, eps, tau_to):
    """Jacobian masks (s, act, sgn, outside) from kink margins.

    ``eps`` shifts every kink decision: 0 reproduces the nominal
    one-sided element; -e treats components within e of a kink as
    active/outside (EXPAND); +e as inactive/inside (SHRINK).
    """
    ms, ma, mo, dir_ = (margins[k] for k in ("ms", "ma", "mo", "dir"))
    dtype = ms.dtype
    s = (ms > eps).to(dtype)
    if tau_to > 0:
        outside = (mo > eps).to(dtype)
        act = (ma > eps).to(dtype) * outside + s * (1.0 - outside)
    else:
        outside = torch.zeros_like(mo)
        act = s
    sgn = dir_ * act * outside
    return s, act, sgn, outside


def _apply_B_jac(s, act, sgn, outside, x):
    """Apply B' = ball' . shrink' row-wise to x.

    shrink' x = s*x ; ball' (inside) = I, (outside):
    diag(act) - sgn sgn'/|act|.
    """
    sx = s * x
    cnt = torch.clamp(act.sum(dim=-1, keepdim=True), min=1.0)
    proj = act * sx - sgn * ((sgn * sx).sum(dim=-1, keepdim=True) / cnt)
    return torch.where(outside > 0, proj, sx)


# cuSOLVER's SVD (``torch.linalg.svd`` on a card) loops over a batch one
# matrix at a time, each of a few hundred rows taking milliseconds of
# latency-bound kernels: a batch is split over SVD_STREAMS host threads,
# each on a CUDA stream of its own, whose matrices then run at once (the
# same routine on each matrix, so the same bits; chip_smoke.py's
# ``verify_times`` line times both ways).
SVD_STREAMS = 4


def _svd(J):
    """``torch.linalg.svd(J, full_matrices=False)`` of a batch [..., n, n];
    on a card split over SVD_STREAMS streams, one host thread each."""
    batch = J.shape[:-2]
    if not J.is_cuda or batch.numel() < 2:
        return torch.linalg.svd(J, full_matrices=False)
    J = J.reshape((-1,) + J.shape[-2:])
    current = torch.cuda.current_stream(J.device)
    streams = [torch.cuda.Stream(J.device) for _ in range(SVD_STREAMS)]

    def part(chunk, stream):
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = torch.linalg.svd(chunk, full_matrices=False)
            done = torch.cuda.Event()
            done.record(stream)
        for x in out:
            x.record_stream(current)
        return out, done

    with ThreadPoolExecutor(SVD_STREAMS) as pool:
        parts = list(pool.map(part, torch.chunk(J, SVD_STREAMS), streams))
    for _, done in parts:
        current.wait_event(done)
    return tuple(torch.cat([out[k] for out, _ in parts]).reshape(
        batch + parts[0][0][k].shape[1:]) for k in range(3))


def _pinv_solve(J, b, rcond, lstsq=False, timer=None):
    """Minimum-norm least-squares solve of J x = b by an explicit SVD
    pseudo-inverse, batched over J's leading axis, on J's device. Singular
    values at or below ``rcond`` times the largest get a zero step (with
    ``lstsq``, below it: ``jnp.linalg.lstsq``'s rule; else
    ``_minnorm_solve``'s); ``timer`` times the SVD as stage "svd"."""
    with _stage(timer, "svd", J):
        U, s, Vh = _svd(J)
    cutoff = rcond * s[..., :1]
    keep = ((s > 0) & (s >= cutoff)) if lstsq else (s > cutoff)
    sinv = torch.where(keep, 1.0 / torch.clamp(s, min=1e-300),
                       torch.zeros_like(s))
    t = sinv * torch.einsum("...ik,...i->...k", U, b)
    return torch.einsum("...ki,...k->...i", Vh, t)


# ---------------------------------------------------------------------------
# Active-set Newton
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _as_newton_solver(H, N, c, tau_to, ridge, num_newton):
    """Batched inner Newton solver for the active-set KKT system.

    Built once per (shape, constants) signature and cached: the pattern
    loop calls it ~10 times per polish. ``F`` is the residual of a batch of
    problems; the Jacobian is ``vmap(jacfwd(.))`` of it on one problem.
    Each step is the minimum-norm least-squares step (SVD, rcond 1e-12)
    with a branch-free backtracking ladder on ||F||.
    """
    m = H * N

    def F(x, r_, w_init_, S_, A_, sgn_, B_):
        w_ = x[:, :m].reshape(-1, H, N)
        q_ = x[:, m:2 * m].reshape(-1, H, N)
        lam = x[:, 2 * m:2 * m + H]
        kap = x[:, 2 * m + H:]
        port_ = (w_ * r_).sum(dim=-1, keepdim=True)
        grad_ = -r_ / torch.clamp(port_, min=1e-12) + ridge * w_
        prev = torch.cat([w_init_[:, None, :], w_[:, :-1]], dim=1)
        u_ = w_ - prev
        nxt = torch.cat([q_[:, 1:], torch.zeros_like(q_[:, :1])], dim=1)
        Dtq = q_ - nxt
        F1 = S_ * (grad_ + Dtq - lam[..., None]) + (1.0 - S_) * w_
        F2 = A_ * (q_ - (c + kap[..., None]) * sgn_) + (1.0 - A_) * u_
        F3 = w_.sum(dim=-1) - 1.0
        F4 = B_ * ((sgn_ * u_).sum(dim=-1) - tau_to) + (1.0 - B_) * kap
        return torch.cat([F1.flatten(1), F2.flatten(1), F3, F4], dim=1)

    def F_one(x, *args):
        return F(x[None], *(a[None] for a in args))[0]

    J_b = vmap(jacfwd(F_one))

    def solve(x, r, w_init, S, A, sgn, B, live, timer=None):
        """``num_newton`` steps on the problems ``live`` (indices); returns
        (x, stalled). A step that does not lower ||F|| leaves the problem's
        x as it was, so its next step would repeat it exactly: the problem
        is ``stalled`` and takes no more steps in this call (on the card
        each step's SVD loops over the problems it is given)."""
        args = (r, w_init, S, A, sgn, B)
        stalled = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for _ in range(num_newton):
            if live.numel() == 0:
                break
            xs = x[live]
            a = tuple(t[live] for t in args)
            Fx = F(xs, *a)
            J = J_b(xs, *a)
            # Min-norm Newton step: the system is STRUCTURALLY singular on
            # no-trade dates (a date whose whole sign pattern is zero forces
            # u_t = 0, making the simplex-sum row redundant and leaving a
            # (q_t, lambda_t) <- (q_t + a, lambda_t + a) null direction). A
            # plain LU walks arbitrarily far along it; the min-norm step
            # keeps the null component at zero, and any exact KKT q inside
            # the box is an exact PDHG fixed point.
            delta = _pinv_solve(J, Fx, 1e-12, lstsq=True, timer=timer)
            # Backtracking on ||F||: the full step can drive w.r through
            # zero, where grad g blows up; the ladder keeps the best
            # decrease and stays put when nothing improves.
            f0 = torch.linalg.vector_norm(Fx, dim=-1)
            x_best, f_best = xs, f0
            for alpha in (1.0, 0.5, 0.25, 0.125, 0.0625):
                x_try = xs - alpha * delta
                f_try = torch.linalg.vector_norm(F(x_try, *a), dim=-1)
                take = torch.isfinite(f_try) & (f_try < f_best)
                x_best = torch.where(take[:, None], x_try, x_best)
                f_best = torch.where(take, f_try, f_best)
            x = x.index_copy(0, live, x_best)
            moved = f_best < f0
            stalled = stalled.index_fill(0, live[~moved], True)
            live = live[moved]
        return x, stalled

    return solve


def _active_set_newton(
    w: torch.Tensor,
    p: torch.Tensor,
    r: torch.Tensor,
    w_init: torch.Tensor,
    params: MPCParams,
    num_newton: int = 4,
    num_pattern: int = 8,
    timer=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the KKT system exactly on the active set guessed from (w, p).

    On a guessed (support S, turnover sign pattern sigma, ball boundary set
    B) the KKT conditions are a SQUARE SMOOTH system in (w, q, lambda,
    kappa):

        i in S_t:      grad g(w)_ti + (D'q)_ti - lambda_t = 0
        i not in S_t:  w_ti = 0
        sigma_ti != 0: q_ti - (c + kappa_t) sigma_ti = 0
        sigma_ti == 0: u_ti = 0                (u = D w - b)
        all t:         sum_i w_ti = 1
        t in B:        sum_i sigma_ti u_ti = tau_to   else  kappa_t = 0

    which plain Newton drives to machine precision in a few steps; an exact
    KKT point is an exact PDHG fixed point, so the caller's
    residual-acceptance test certifies it. Pattern guesses come from primal
    signals (the projected iterate's support, its trades); wrong guesses
    give a worse residual and are rejected per problem. ``r`` are the gross
    returns. Returns (w*, q*) with the caller's batch shape.
    """
    dtype = w.dtype
    c = params.cost_coeff
    tau_to = params.max_turnover
    ridge = params.ridge
    H, N = w.shape[-2:]
    m = H * N
    batch_shape = w.shape[:-2]

    # --- Pattern guesses (per problem) ---
    # Primal signals, not dual: under the degenerate complementarity of
    # near-zero-return dates the duals cluster AT the subgradient bound
    # while their trades are zero. The support comes from the PROJECTED
    # iterate P(w - tau(grad + D'p)): a line-searched Newton iterate has no
    # exact zeros.
    tau_cv, sigma_cv = _fixed_point_steps(r, params)
    port0 = (w * r).sum(dim=-1, keepdim=True)
    grad0 = -r / torch.clamp(port0, min=1e-12) + ridge * w
    vw0 = w - tau_cv * (grad0 + _apply_Dt(p))
    w_proj, _ = _proj_simplex_with_margin(vw0)
    S = (w_proj > 0.0).to(dtype)                              # support
    w = w_proj                                                # Newton start
    u0 = _apply_D(w, w_init)
    # tol_u separates true trades from PDHG residual noise (~1e-7 after a
    # converged solve). It must be small: drifted pre-trade weights carry
    # tiny positions, and selling one to zero is a true trade of size
    # w_init_i. Components that leave (or enter) the support are forced
    # into the sign pattern outright: such a transition is a trade in
    # either direction whatever its size, and leaving it out would pin
    # w_t = w_prev against the support, an inconsistent system.
    tol_u = 1e-6
    prev_sup = torch.cat(
        [(w_init > 0.0)[..., None, :].to(dtype), S[..., :-1, :]], dim=-2)
    forced_leave = (S == 0.0) & (prev_sup > 0.0)
    forced_enter = (S > 0.0) & (prev_sup == 0.0)
    A = ((u0.abs() > tol_u) | forced_leave | forced_enter).to(dtype)
    default_sign = torch.where(forced_enter, 1.0, -1.0).to(dtype)
    sgn = torch.where(u0.abs() > 0, torch.sign(u0), default_sign) * A
    kappa0 = torch.clamp(p.abs().amax(dim=-1) - c, min=0.0)   # [..., H]
    if tau_to > 0:
        l1_u = u0.abs().sum(dim=-1)
        Bmask = (l1_u >= tau_to * (1.0 - 1e-3)).to(dtype)    # [..., H]
        kappa0 = kappa0 * Bmask
    else:
        Bmask = torch.zeros_like(kappa0)
        kappa0 = torch.zeros_like(kappa0)

    # lambda_0 from stationarity averaged over the support.
    port = (w * r).sum(dim=-1, keepdim=True)
    grad = -r / torch.clamp(port, min=1e-12) + ridge * w
    stat = grad + _apply_Dt(p)
    lam0 = (S * stat).sum(dim=-1) / torch.clamp(S.sum(dim=-1), min=1.0)

    nb = int(np.prod(batch_shape)) if batch_shape else 1
    x = torch.cat([w.reshape(nb, m), p.reshape(nb, m), lam0.reshape(nb, H),
                   kappa0.reshape(nb, H)], dim=-1)            # [nb, 2m+2H]

    solver = _as_newton_solver(H, N, float(c), float(tau_to), float(ridge),
                               num_newton)

    rb = r.reshape(nb, H, N)
    wib = w_init.reshape(nb, N)
    S = S.reshape(nb, H, N)
    A = A.reshape(nb, H, N)
    sgn = sgn.reshape(nb, H, N)
    Bmask = Bmask.reshape(nb, H)
    tol = 1e-9

    def _forced_transitions(S_):
        """Support transitions that force a trade whatever its size
        (drifted pre-trade weights carry positions down to ~1e-10; leaving
        such a micro-sell out of the sign pattern makes the equality
        system inconsistent at exactly that scale). Recomputed per pattern
        round so the updates can never lose them."""
        prev_ = torch.cat([(wib > 0.0)[:, None, :].to(dtype), S_[:, :-1, :]],
                          dim=1)
        return (S_ == 0.0) & (prev_ > 0.0), (S_ > 0.0) & (prev_ == 0.0)

    # The PDHG fixed-point residual (the caller's certificate) tracks the
    # best iterate across pattern rounds: flip-all active-set updates can
    # oscillate between near-optimal patterns.
    sig_b = sigma_cv.reshape(nb, 1, 1)
    tau_b = tau_cv.reshape(nb, 1, 1)

    def _pdhg_res(w_, q_):
        port_ = (w_ * rb).sum(dim=-1, keepdim=True)
        grad_ = -rb / torch.clamp(port_, min=1e-12) + ridge * w_
        nxt = torch.cat([q_[:, 1:], torch.zeros_like(q_[:, :1])], dim=1)
        vw_ = w_ - tau_b * (grad_ + (q_ - nxt))
        Pw_, _ = _proj_simplex_with_margin(vw_)
        prev = torch.cat([wib[:, None, :], w_[:, :-1]], dim=1)
        vp_ = q_ + sig_b * (w_ - prev)
        Qp_, _ = _Q_with_margins(vp_, sig_b, c, tau_to)
        return torch.sqrt(((w_ - Pw_) ** 2).sum(dim=(-2, -1))
                          + ((q_ - Qp_) ** 2).sum(dim=(-2, -1)))

    best_res = torch.full((nb,), float("inf"), dtype=dtype, device=w.device)
    best_w = x[:, :m].reshape(nb, H, N)
    best_q = x[:, m:2 * m].reshape(nb, H, N)

    # Active-set iteration: solve the equality system on the pattern, then
    # update the pattern from the solution's sign violations (negative
    # supported weights leave S; nonsupport components with negative
    # multipliers enter; traded components whose sign flipped leave the
    # sign pattern; zero-trade components whose subgradient escaped the
    # box enter with its sign; the ball (de)activates on kappa < 0 /
    # l1 > tau), keeping the best-residual iterate seen. The host loop
    # stops once every problem is at certificate precision, or once the
    # masks are unchanged and the best residual stopped improving.
    # A problem whose solve stalled (its last step made no progress) and
    # whose masks the update left as they were would re-run the identical
    # system from the same point, a no-op: it is frozen and left out of the
    # later solves.
    frozen = torch.zeros(nb, dtype=torch.bool, device=x.device)
    prev_masks = None
    for _ in range(num_pattern):
        x, stalled = solver(x, rb, wib, S, A, sgn, Bmask,
                            torch.nonzero(~frozen).flatten(), timer)
        used = (S, A, sgn, Bmask)
        w_ = x[:, :m].reshape(nb, H, N)
        q_ = x[:, m:2 * m].reshape(nb, H, N)
        lam_ = x[:, 2 * m:2 * m + H]
        kap_ = x[:, 2 * m + H:]
        res_ = _pdhg_res(w_, q_)
        take = torch.isfinite(res_) & (res_ < best_res)
        best_res = torch.where(take, res_, best_res)
        best_w = torch.where(take[:, None, None], w_, best_w)
        best_q = torch.where(take[:, None, None], q_, best_q)

        port_ = (w_ * rb).sum(dim=-1, keepdim=True)
        grad_ = -rb / torch.clamp(port_, min=1e-12) + ridge * w_
        nxt = torch.cat([q_[:, 1:], torch.zeros_like(q_[:, :1])], dim=1)
        stat = grad_ + (q_ - nxt)
        mu = stat - lam_[..., None]       # nonsupport multiplier (>= 0)
        prev = torch.cat([wib[:, None, :], w_[:, :-1]], dim=1)
        u_ = w_ - prev
        bound_ = c + kap_[..., None]

        S = torch.where(S > 0, (w_ > -tol).to(dtype), (mu < -tol).to(dtype))
        sign_ok = (torch.sign(u_) == torch.sign(sgn)) | (u_.abs() <= tol)
        A_new = torch.where(
            A > 0,
            sign_ok.to(dtype) * (u_.abs() > tol).to(dtype),
            (q_.abs() > bound_ * (1.0 + 1e-9) + tol).to(dtype),
        )
        sgn_new = torch.where(A > 0, sgn * A_new, torch.sign(q_) * A_new)
        # Re-force support-transition trades against the |u| > tol drop.
        f_leave, f_enter = _forced_transitions(S)
        forced = f_leave | f_enter
        A = torch.where(forced, torch.ones_like(A_new), A_new)
        sgn = torch.where(
            forced,
            torch.where(u_.abs() > 0, torch.sign(u_),
                        torch.where(f_enter, 1.0, -1.0).to(dtype)),
            sgn_new,
        )
        if tau_to > 0:
            l1_ = u_.abs().sum(dim=-1)
            Bmask = torch.where(Bmask > 0, (kap_ > -tol).to(dtype),
                                (l1_ > tau_to + tol).to(dtype))

        same = torch.ones(nb, dtype=torch.bool, device=x.device)
        for a, b in zip((S, A, sgn, Bmask), used):
            same &= (a == b).flatten(1).all(dim=1)
        frozen |= stalled & same
        # A problem at certificate precision takes no more rounds either:
        # the loop below stops once every problem is there.
        frozen |= best_res < 1e-13

        if bool((best_res < 1e-13).all()):
            break
        cur_masks = (S, A, sgn, Bmask)
        # Unchanged masks mean the next solve re-runs the identical system,
        # but extra Newton rounds on a fixed pattern can still grind the
        # residual down: stop only once best_res stopped improving too.
        improved = bool(take.any())
        if (prev_masks is not None and not improved and all(
                torch.equal(a, b) for a, b in zip(cur_masks, prev_masks))):
            break
        prev_masks = cur_masks

    x, _ = solver(x, rb, wib, S, A, sgn, Bmask,
                  torch.nonzero(~frozen).flatten(), timer)
    w_ = x[:, :m].reshape(nb, H, N)
    q_ = x[:, m:2 * m].reshape(nb, H, N)
    res_ = _pdhg_res(w_, q_)
    take = torch.isfinite(res_) & (res_ < best_res)
    best_w = torch.where(take[:, None, None], w_, best_w)
    best_q = torch.where(take[:, None, None], q_, best_q)
    return best_w.reshape(w.shape), best_q.reshape(p.shape)


# ---------------------------------------------------------------------------
# Boundary-aware pattern refinement (host, per instance)
# ---------------------------------------------------------------------------
#
# The last certification stragglers (realistic instances, every date's
# turnover ball exactly active) stall because the PDHG iterate cannot
# resolve the micro-structure of the optimum: pre-trade weights carry dust
# positions (w_init_i ~ 1e-10..1e-8, float32 backtest drift) whose optimal
# treatment (hold untraded through the horizon, or sell on some date)
# changes the objective by less than the solver's resolution, while the KKT
# certificate depends on getting that combinatorial choice exactly right.
#
# The refinement solves the combinatorial boundary problem directly:
#   1. enumerate the dust positions' sell dates (including "never"),
#   2. for each candidate pattern solve the RESTRICTED PRIMAL, the
#      pattern-pinned, strictly convex (ridge) problem whose unique
#      minimizer cannot drift along the KKT system's dual null space,
#   3. reconstruct duals by a slack-maximizing feasibility LP (exact
#      stationarity equalities, strict-interior bound inequalities),
#   4. accept the candidate iff the PDHG fixed-point residual of the
#      (primal, LP-dual) pair beats the incumbent.
# Host only: numpy, a float64 torch residual and Jacobian on the CPU, one
# small HiGHS LP per candidate.


@lru_cache(maxsize=32)
def _restricted_primal_solver(H, N, c, tau_to, ridge):
    """Residual and Jacobian (float64, on the CPU) of the
    pattern-restricted primal KKT. Masks are arguments, so one pair of
    functions serves every candidate pattern. Unknowns x = (w [H*N],
    alpha [H] simplex multipliers, beta [H] ball multipliers); equations:
    stationarity on free coords (in support and traded), w = 0 off
    support, u = 0 for untraded support coords, simplex sums, ball
    equalities (or beta = 0 off the ball).
    """
    m = H * N

    def FP(x, rj, cwj, S, A, sgn, Bm):
        w_ = x[:m].reshape(H, N)
        al = x[m:m + H]
        be = x[m + H:]
        port = (w_ * rj).sum(dim=-1, keepdim=True)
        grad = -rj / torch.clamp(port, min=1e-12) + ridge * w_
        prev = torch.cat([cwj[None], w_[:-1]], dim=0)
        u_ = w_ - prev
        csg = (c + be[:, None]) * sgn
        nxt = torch.cat([csg[1:], torch.zeros((1, N), dtype=x.dtype)], dim=0)
        gts = csg - nxt
        F1 = S * A * (grad + gts - al[:, None]) + (1 - S) * w_
        F2 = S * (1 - A) * u_
        F3 = w_.sum(dim=-1) - 1.0
        F4 = Bm * ((sgn * u_).sum(dim=-1) - tau_to) + (1 - Bm) * be
        return torch.cat([F1.reshape(-1), F2.reshape(-1), F3, F4])

    return FP, jacfwd(FP)


def _solve_restricted_primal(w_start, cw, r, S, A, sgn, Bm, params,
                             steps=40):
    """Newton (lstsq + backtracking) on the restricted primal KKT, float64
    on the host. Returns (w [H, N], final residual norm). The w-part of any
    solution is unique (ridge strong convexity on an affine set); redundant
    constraint rows only leave the multipliers underdetermined, which the
    min-norm lstsq step handles."""
    H, N = r.shape
    m = H * N
    Fj, Jf = _restricted_primal_solver(
        H, N, float(params.cost_coeff), float(params.max_turnover),
        float(params.ridge),
    )
    args = tuple(torch.as_tensor(np.asarray(a, np.float64))
                 for a in (r, cw, S, A, sgn, Bm))

    def F(x):
        return Fj(torch.from_numpy(x), *args).numpy()

    x = np.concatenate([np.asarray(w_start, np.float64).ravel(),
                        np.zeros(2 * H)])
    fb = float(np.linalg.norm(F(x)))
    for _ in range(steps):
        Fx = F(x)
        f0 = float(np.linalg.norm(Fx))
        if f0 < 1e-15:
            fb = f0
            break
        J = Jf(torch.from_numpy(x), *args).numpy()
        dx, _, _, _ = np.linalg.lstsq(J, Fx, rcond=1e-13)
        best, fb = x, f0
        for a in (1.0, 0.5, 0.25, 0.125):
            xt = x - a * dx
            ft = float(np.linalg.norm(F(xt)))
            if np.isfinite(ft) and ft < fb:
                best, fb = xt, ft
        if fb >= f0 * 0.999999:
            break
        x = best
    return x[:m].reshape(H, N), fb


def _dual_slack_lp(grad, S, A, sgn, Bm, c):
    """Slack-maximizing dual feasibility LP at a solved primal.

    Variables (q [H*N], lam [H], kap [H], s); maximize s subject to
      in support:   grad + q_t - q_{t+1} - lam_t  = 0
      off support:  grad + q_t - q_{t+1} - lam_t >= s      (mu >= s)
      traded:       q = (c + kap_t) * sgn
      untraded:     |q| <= c + kap_t - s
      ball active:  kap_t >= s        else  kap_t = 0.
    A feasible solution with s >= 0 is an exact dual certificate for the
    candidate pattern at this primal; s > 0 additionally proves strict
    complementarity, which is what makes the PDHG fixed-point residual
    collapse to machine precision. Returns (q [H, N], s) or None.
    """
    from scipy.optimize import linprog

    H, N = grad.shape
    m = H * N
    nv = m + 2 * H + 1
    isl = nv - 1
    rows_eq, b_eq, rows_ub, b_ub = [], [], [], []
    for t in range(H):
        for i in range(N):
            stat = np.zeros(nv)
            stat[t * N + i] = 1.0
            if t + 1 < H:
                stat[(t + 1) * N + i] = -1.0
            stat[m + t] = -1.0
            if S[t, i] > 0:
                rows_eq.append(stat)
                b_eq.append(-grad[t, i])
            else:
                r_ = -stat
                r_[isl] = 1.0
                rows_ub.append(r_)
                b_ub.append(grad[t, i])
            if A[t, i] > 0:
                pin = np.zeros(nv)
                pin[t * N + i] = 1.0
                pin[m + H + t] = -sgn[t, i]
                rows_eq.append(pin)
                b_eq.append(c * sgn[t, i])
            else:
                for sg in (1.0, -1.0):
                    box = np.zeros(nv)
                    box[t * N + i] = sg
                    box[m + H + t] = -1.0
                    box[isl] = 1.0
                    rows_ub.append(box)
                    b_ub.append(c)
        krow = np.zeros(nv)
        if Bm[t] > 0:
            krow[m + H + t] = -1.0
            krow[isl] = 1.0
            rows_ub.append(krow)
            b_ub.append(0.0)
        else:
            krow[m + H + t] = 1.0
            rows_eq.append(krow)
            b_eq.append(0.0)
    cost = np.zeros(nv)
    cost[isl] = -1.0
    res = linprog(cost, A_ub=np.array(rows_ub), b_ub=np.array(b_ub),
                  A_eq=np.array(rows_eq), b_eq=np.array(b_eq),
                  bounds=[(None, None)] * nv, method="highs")
    if not res.success or res.x[isl] < -1e-12:
        return None
    return res.x[:m].reshape(H, N), float(res.x[isl])


def _pair_residual(w, q, r, cw, params):
    """PDHG fixed-point residual of a (w, q) candidate pair, float64 on the
    host: the quantity polish_log_utility certifies, with its step-size
    constants. numpy in ([H, N], [N]; r the gross returns), float out."""
    rn = np.sum(r * r, -1)
    rm = np.min(r, -1)
    L = float(np.max(rn / np.maximum(rm, 1e-12) ** 2)) + params.ridge
    sigma = params.sigma_scale * np.sqrt(L) / 2.0
    tau = params.step_scale / (0.5 * L + sigma * 4.0)
    wj, qj, rj, cwj = (torch.as_tensor(np.asarray(a, np.float64))
                       for a in (w, q, r, cw))
    port = (wj * rj).sum(dim=-1, keepdim=True)
    grad = -rj / torch.clamp(port, min=1e-12) + params.ridge * wj
    Pw, _ = _proj_simplex_with_margin(wj - tau * (grad + _apply_Dt(qj)))
    Qp, _ = _Q_with_margins(qj + sigma * _apply_D(wj, cwj), sigma,
                            params.cost_coeff, params.max_turnover)
    return float(torch.sqrt(((wj - Pw) ** 2).sum() + ((qj - Qp) ** 2).sum()))


def _boundary_refine_instance(w, p, cw, y, params):
    """Boundary-aware refinement of one uncertified instance (see the
    section comment above). All inputs numpy float64, single instance
    ([H, N] / [N]). Returns (w_ref [H, N], q_ref [H, N], residual) or
    None when no candidate certifies or improves.
    """
    if params.allow_short or params.max_turnover <= 0:
        return None
    H, N = y.shape
    r = np.exp(y)
    c = params.cost_coeff
    tau_to = params.max_turnover
    ridge = params.ridge
    u0 = w - np.vstack([cw[None], w[:-1]])
    port = (w * r).sum(-1, keepdims=True)
    grad0 = -r / np.maximum(port, 1e-12) + ridge * w
    Dtq = p - np.vstack([p[1:], np.zeros((1, N))])
    stat = grad0 + Dtq
    S_conf = w > 1e-6
    lam0 = (S_conf * stat).sum(-1) / np.maximum(S_conf.sum(-1), 1)
    mu = stat - lam0[:, None]
    # Support: confident holdings, plus parked small values whose
    # stationarity multiplier is ~0 (genuine tiny optimal holdings, as
    # opposed to the geometric decay tails PDHG leaves on sold positions,
    # whose mu is strictly positive).
    S_base = ((w > 1e-6) | ((w > 1e-10) & (mu < 1e-5))).astype(float)
    Bm = (np.abs(u0).sum(-1) >= tau_to * (1.0 - 1e-3)).astype(float)
    micro = np.where((cw > 0) & (cw < 1e-6))[0]
    if micro.size > 8:                   # cap the product enumeration
        micro = micro[np.argsort(-cw[micro])][:8]

    def build_trades(S):
        prev_sup = np.vstack([(cw > 1e-14)[None].astype(float), S[:-1]])
        f_leave = (S == 0) & (prev_sup > 0)
        f_enter = (S > 0) & (prev_sup == 0)
        A = ((np.abs(u0) > 1e-6) | f_leave | f_enter).astype(float)
        sgn = np.where(np.abs(u0) > 1e-6, np.sign(u0),
                       np.where(f_enter, 1.0, -1.0)) * A
        return A, sgn

    # Candidate structures: per dust position, the sell date (0..H-1) or
    # hold-throughout (H), pre-screened by the slack LP at the ITERATE's
    # gradient. The total count is capped: above 1536 candidates only the
    # first few sell dates plus "never" are enumerated (dust sells, when
    # optimal at all, happen immediately). H=5's full enumeration
    # (6^4 = 1296) stays whole.
    date_opts = list(range(H + 1))
    if micro.size and len(date_opts) ** len(micro) > 1536:
        keep = max(2, int(1536 ** (1.0 / len(micro))))
        date_opts = list(range(keep - 1)) + [H]
    sell_options = list(product(date_opts, repeat=len(micro))) \
        if micro.size else [()]
    screened = []
    for opt in sell_options:
        S = S_base.copy()
        for i_m, ts in zip(micro, opt):
            S[:, i_m] = [1.0 if t < ts else 0.0 for t in range(H)]
        A, sgn = build_trades(S)
        lp = _dual_slack_lp(grad0, S, A, sgn, Bm, c)
        if lp is not None:
            screened.append((lp[1], opt, S, A, sgn))

    # NET-EXCESS MICRO-TRADE candidates (the equal-weight tie class, every
    # backtest's first solve): float32-stored pre-trade weights do not sum
    # to exactly 1, so the t=0 simplex row forces a net trade of -delta
    # that the |u| > 1e-6 classification cannot see. The optimum absorbs
    # delta through ONE asset: enumerate which. Wrong enumerations lose the
    # residual comparison.
    delta = float(cw.sum()) - 1.0
    if abs(delta) > 1e-13:
        sell_sign = -np.sign(delta)
        A_b, sgn_b = build_trades(S_base)
        for i_s in range(N):
            if S_base[0, i_s] <= 0 or A_b[0, i_s] > 0:
                continue
            A2 = A_b.copy()
            sg2 = sgn_b.copy()
            A2[0, i_s] = 1.0
            sg2[0, i_s] = sell_sign
            lp = _dual_slack_lp(grad0, S_base, A2, sg2, Bm, c)
            if lp is not None:
                screened.append((lp[1], ("net", i_s), S_base.copy(),
                                 A2, sg2))
    if not screened:
        return None
    screened.sort(key=lambda z: -z[0])

    best = None
    for slack0, opt, S, A, sgn in screened[:6]:
        # Primal solve with negative-support repair: a support component
        # the restricted solve drives negative is misclassified: drop it,
        # rebuild the forced-transition trades, and re-solve.
        is_net = isinstance(opt, tuple) and len(opt) and opt[0] == "net"
        S = S.copy()
        for _ in range(4):
            wf, fprim = _solve_restricted_primal(w, cw, r, S, A, sgn,
                                                 Bm, params)
            neg = (S > 0) & (wf < -1e-12)
            if not neg.any():
                break
            S[neg] = 0.0
            A, sgn = build_trades(S)
            if is_net and S[0, opt[1]] > 0:
                # re-apply the net-excess micro-trade pin the rebuild
                # cannot see (|u| ~ 1e-8 < the 1e-6 classification)
                A[0, opt[1]] = 1.0
                sgn[0, opt[1]] = -np.sign(delta)
        if fprim > 1e-11 or wf.min() < -1e-10:
            continue
        wf = np.maximum(wf, 0.0)
        # l1 <= tau must hold on non-pinned dates too
        uf = wf - np.vstack([cw[None], wf[:-1]])
        if np.any(np.abs(uf).sum(-1) > tau_to + 1e-10):
            continue
        gradf = (-r / np.maximum((wf * r).sum(-1, keepdims=True), 1e-12)
                 + ridge * wf)
        lp = _dual_slack_lp(gradf, S, A, sgn, Bm, c)
        if lp is None:
            continue
        qf, _ = lp
        rr = _pair_residual(wf, qf, r, cw, params)
        if best is None or rr < best[2]:
            best = (wf, qf, rr)
        if rr < 1e-13:
            break
    return best


def _interior_point_instance(cw, y, params, iters_per_mu=12):
    """Host float64 primal-dual barrier solve of ONE instance: the
    pipeline's pattern-free fallback.

    The split-variable form (u = u+ - u-, ball slack s)

        min  -sum_t log(w_t . r_t) + (ridge/2)||w||^2 + c 1'(u+ + u-)
        s.t. w_t - w_{t-1} - u+_t + u-_t = 0      (flow; multipliers = q)
             1'w_t = 1,   1'(u+_t + u-_t) + s_t = tau_to
             w, u+, u-, s >= 0                    (log barrier)

    is smooth inside the cone, so a damped Newton path-following loop (KKT
    solves on [H A'; A 0] with one iterative-refinement step,
    fraction-to-boundary steps, mu *= 0.15 stages down to ~2e-16) needs no
    active-set guess at all. The barrier converges to the analytic centre
    of the optimal face (maximal strict complementarity), from which the
    semismooth polish finishes superlinearly. Returns (w [H, N], q [H, N])
    or None on numerical failure.
    """
    H, N = y.shape
    r = np.exp(np.asarray(y, np.float64))
    cw = np.asarray(cw, np.float64)
    ridge = params.ridge
    c = params.cost_coeff
    tau_to = params.max_turnover
    if tau_to <= 0 or params.allow_short:
        return None
    if H * N > 256:
        # The dense KKT is [(3HN+H)+(HN+2H)]^2 per Newton step: past
        # H*N = 256 skip rather than hang the pipeline.
        logging.getLogger(__name__).info(
            "interior-point fallback skipped: H*N = %d > 256", H * N
        )
        return None
    m = H * N
    nx = 3 * m + H
    neq = m + 2 * H
    A = np.zeros((neq, nx))
    b = np.zeros(neq)
    for t in range(H):
        for i in range(N):
            row = t * N + i
            A[row, t * N + i] = 1.0
            if t > 0:
                A[row, (t - 1) * N + i] = -1.0
            A[row, m + t * N + i] = -1.0
            A[row, 2 * m + t * N + i] = 1.0
            b[row] = cw[i] if t == 0 else 0.0
        cols = [t * N + i for i in range(N)]
        A[m + t, cols] = 1.0
        b[m + t] = 1.0
        A[m + H + t, [m + cc for cc in cols]] = 1.0
        A[m + H + t, [2 * m + cc for cc in cols]] = 1.0
        A[m + H + t, 3 * m + t] = 1.0
        b[m + H + t] = tau_to

    def fgrad(x, mu_b):
        W = x[:m].reshape(H, N)
        port = (W * r).sum(-1)
        g = np.zeros(nx)
        g[:m] = (-r / np.maximum(port, 1e-300)[:, None]
                 + ridge * W).reshape(-1) - mu_b / np.maximum(x[:m], 1e-300)
        g[m:2 * m] = c - mu_b / np.maximum(x[m:2 * m], 1e-300)
        g[2 * m:3 * m] = c - mu_b / np.maximum(x[2 * m:3 * m], 1e-300)
        g[3 * m:] = -mu_b / np.maximum(x[3 * m:], 1e-300)
        return g, port

    def fhess(x, mu_b, port):
        Hm = np.zeros((nx, nx))
        for t in range(H):
            cols = np.arange(t * N, (t + 1) * N)
            Hm[np.ix_(cols, cols)] += np.outer(r[t], r[t]) / port[t] ** 2
        idx = np.arange(nx)
        bar = mu_b / np.maximum(x, 1e-300) ** 2
        Hm[idx, idx] += bar
        Hm[np.arange(m), np.arange(m)] += ridge
        return Hm

    # Strictly positive start near the pre-trade portfolio.
    W0 = np.tile(np.maximum(cw, 1e-6) / np.maximum(cw, 1e-6).sum(),
                 (H, 1))
    u0 = W0 - np.vstack([cw[None], W0[:-1]])
    up0 = (np.maximum(u0, 0) + 1e-4).reshape(-1)
    um0 = (np.maximum(-u0, 0) + 1e-4).reshape(-1)
    s0 = np.maximum(tau_to - (up0 + um0).reshape(H, N).sum(-1), 1e-4)
    x = np.concatenate([W0.reshape(-1), up0, um0, s0])
    yv = np.zeros(neq)
    mu_b = 1e-2
    while mu_b > 2e-16:
        for _ in range(iters_per_mu):
            g, port = fgrad(x, mu_b)
            Hm = fhess(x, mu_b, port)
            KKT = np.block([[Hm, A.T], [A, np.zeros((neq, neq))]])
            rhs = np.concatenate([-g, b - A @ x])
            try:
                sol = np.linalg.solve(KKT, rhs)
                # One iterative-refinement step: at mu ~ 1e-15 the KKT
                # matrix's condition is ~1/mu; the refinement buys the
                # digit that lets the barrier floor reach 2e-16.
                sol = sol + np.linalg.solve(KKT, rhs - KKT @ sol)
            except np.linalg.LinAlgError:
                sol, *_ = np.linalg.lstsq(KKT, rhs, rcond=None)
            if not np.all(np.isfinite(sol)):
                return None
            dx = sol[:nx]
            yv = sol[nx:]
            neg = dx < 0
            alpha = 1.0
            if neg.any():
                alpha = min(1.0, 0.995 * float(np.min(-x[neg] / dx[neg])))
            x = x + alpha * dx
            res_kkt = (np.linalg.norm(g + A.T @ yv)
                       + np.linalg.norm(b - A @ x))
            if res_kkt < max(mu_b * 1e-2, 1e-14) and alpha > 0.9:
                break
        mu_b *= 0.15
    if not np.all(np.isfinite(x)):
        return None
    return x[:m].reshape(H, N), yv[:m].reshape(H, N)


# ---------------------------------------------------------------------------
# Extended-precision polish (host, numpy longdouble)
# ---------------------------------------------------------------------------
#
# The last uncertified class (the equal-weight maximal-tie instance, every
# backtest's first solve, plus near-tie stragglers) parks at a
# ~1.5e-10..3e-9 residual attractor under every float64 stage: on the
# maximal-tie face the generalized Jacobian's conditioning is ~1e9-1e10, so
# a float64 Newton step's forward error is eps_f64 * cond. That is a
# precision floor, so the same kink-aware semismooth Newton runs again in
# 80-bit extended precision (numpy longdouble, eps ~ 1.1e-19), and the
# refined point rounded back to float64 evaluates the float64 certificate
# residual far below the 1e-10 bar. Plain vectorized numpy longdouble: exact
# sort-based projections, dense J assembled by applying the Jacobian action
# to the identity, and a partial-pivot LU (LAPACK has no longdouble path).
# Gated to H*N <= 1024.


def _ld_simplex_threshold(v, radius):
    """Exact simplex-projection threshold per trailing row (sort-based
    Held/Duchi algorithm, finite), any float dtype. Returns theta with
    shape v.shape[:-1] + (1,)."""
    s = np.sort(v, axis=-1)[..., ::-1]
    cs = np.cumsum(s, axis=-1)
    k = np.arange(1, v.shape[-1] + 1, dtype=v.dtype)
    active = s - (cs - radius) / k > 0
    rho = np.maximum(np.sum(active, axis=-1, keepdims=True), 1)
    cs_r = np.take_along_axis(cs, rho - 1, axis=-1)
    return (cs_r - radius) / rho.astype(v.dtype)


def _ld_lu_solve(A, b):
    """Partial-pivot LU solve in the matrix dtype (vectorized numpy; used
    for longdouble, which LAPACK does not support)."""
    A = A.copy()
    b = b.copy()
    n = A.shape[0]
    for k in range(n - 1):
        piv = k + int(np.argmax(np.abs(A[k:, k])))
        if piv != k:
            A[[k, piv]] = A[[piv, k]]
            b[[k, piv]] = b[[piv, k]]
        akk = A[k, k]
        if akk == 0:
            akk = np.finfo(A.dtype).tiny
        f = A[k + 1:, k] / akk
        A[k + 1:, k + 1:] -= f[:, None] * A[k, k + 1:]
        b[k + 1:] -= f * b[k]
    x = np.zeros_like(b)
    for k in range(n - 1, -1, -1):
        akk = A[k, k]
        if akk == 0:
            akk = np.finfo(A.dtype).tiny
        x[k] = (b[k] - A[k, k + 1:] @ x[k + 1:]) / akk
    return x


def _extended_polish_instance(w, p, cw, y, params, rounds=30,
                              kink_scale=3.0, verbose=False):
    """Kink-aware semismooth Newton on ONE instance in 80-bit longdouble
    (see the section comment above). Inputs float64 ([H, N] / [N]);
    returns (w, q) rounded to float64, or None when the instance is out of
    the supported surface. The caller accepts by the float64
    ``_pair_residual`` comparison, so a failed refinement is harmless."""
    if params.allow_short or params.max_turnover <= 0:
        return None
    H, N = y.shape
    if H * N > 1024:
        return None
    ld = np.longdouble
    r = np.exp(np.asarray(y, ld))
    cw = np.asarray(cw, ld)
    w = np.asarray(w, ld)
    q = np.asarray(p, ld)
    ridge = ld(params.ridge)
    c = ld(params.cost_coeff)
    tau_to = ld(params.max_turnover)
    one = ld(1.0)

    # Step-size constants, matching polish_log_utility / _pair_residual.
    L = np.max(np.sum(r * r, -1) / np.min(r, -1) ** 2) + ridge
    sigma = ld(params.sigma_scale) * np.sqrt(L) / 2
    tau = ld(params.step_scale) / (L / 2 + sigma * 4)

    zrow = np.zeros((1, N), ld)

    def D(x):
        return x - np.vstack([cw[None], x[:-1]])

    def Dt(x):
        return x - np.vstack([x[1:], zrow])

    def residual(w, q):
        port = (w * r).sum(-1, keepdims=True)
        grad = -r / port + ridge * w
        vw = w - tau * (grad + Dt(q))
        mw = vw - _ld_simplex_threshold(vw, one)
        Pw = np.maximum(mw, 0)
        vp = q + sigma * D(w)
        u = vp / sigma
        ms = np.abs(u) - c / sigma
        yv = np.sign(u) * np.maximum(ms, 0)
        a = np.abs(yv)
        mo = a.sum(-1, keepdims=True) - tau_to
        th = np.maximum(_ld_simplex_threshold(a, tau_to), 0)
        ma = a - th
        z = np.where(mo > 0, np.sign(yv) * np.maximum(ma, 0), yv)
        Qp = vp - sigma * z
        dir_ = np.where(yv != 0, np.sign(yv), np.sign(u))
        marg = {"mw": mw, "ms": ms, "ma": ma, "mo": mo, "dir": dir_,
                "port": port}
        return w - Pw, q - Qp, marg

    def norm(Rw, Rp):
        return np.sqrt((Rw * Rw).sum() + (Rp * Rp).sum())

    m = H * N

    def masks_of(marg, eps):
        a_m = (marg["mw"] > eps).astype(ld)
        s_m = (marg["ms"] > eps).astype(ld)
        outside = (marg["mo"] > eps).astype(ld)
        act = ((marg["ma"] > eps) * outside + s_m * (1 - outside))
        return {"a": a_m, "s": s_m, "out": outside, "act": act,
                "dir": marg["dir"], "port": marg["port"]}

    def dense_J_masks(mk):
        a_m, s_m, outside, act = mk["a"], mk["s"], mk["out"], mk["act"]
        sgn = mk["dir"] * act * outside
        port = mk["port"]
        cnt_a = np.maximum(a_m.sum(-1, keepdims=True), 1)
        cnt_s = np.maximum(act.sum(-1, keepdims=True), 1)

        # Apply J to the identity, batched over a leading basis axis.
        eye = np.eye(2 * m, dtype=ld)
        xw = eye[:, :m].reshape(2 * m, H, N)
        xp = eye[:, m:].reshape(2 * m, H, N)
        coeff = (r * xw).sum(-1, keepdims=True) / port ** 2
        hg = r * coeff + ridge * xw
        dtxp = xp - np.concatenate([xp[:, 1:], np.zeros((2 * m, 1, N), ld)],
                                   axis=1)
        dvw = xw - tau * (hg + dtxp)
        ad = a_m * dvw
        Pj = ad - a_m * (ad.sum(-1, keepdims=True) / cnt_a)
        Jw = xw - Pj
        dxw = xw - np.concatenate([np.zeros((2 * m, 1, N), ld), xw[:, :-1]],
                                  axis=1)
        dvp = xp + sigma * dxw
        sx = s_m * dvp
        proj = act * sx - sgn * ((sgn * sx).sum(-1, keepdims=True) / cnt_s)
        Bj = np.where(outside > 0, proj, sx)
        Jp = xp - (dvp - Bj)
        cols = np.concatenate(
            [Jw.reshape(2 * m, m), Jp.reshape(2 * m, m)], axis=1
        )
        return cols.T                                     # [2m out, 2m in]

    alphas = tuple(one / ld(2) ** k for k in range(14))

    def try_masks(mk, rhs, w, q, res_best, w_best, q_best):
        """Newton candidates from one B-subdifferential element: a
        lightly-damped LU step and a residual-scaled Tikhonov /
        normal-equations step (approximately min-norm: it stays bounded
        where J is singular along boundary-degenerate directions), each
        backtracked."""
        res = norm(*residual(w, q)[:2])
        J = dense_J_masks(mk)
        deltas = []
        lam = max(res * ld(0.1), ld(1e-18))
        Jd = J.copy()
        Jd[np.arange(2 * m), np.arange(2 * m)] += lam
        deltas.append(_ld_lu_solve(Jd, rhs))
        mu = max(res * ld(1e-3), ld(1e-18)) ** 2
        JtJ = J.T @ J
        JtJ[np.arange(2 * m), np.arange(2 * m)] += mu
        deltas.append(_ld_lu_solve(JtJ, J.T @ rhs))
        for delta in deltas:
            if not np.all(np.isfinite(delta)):
                continue
            dw = delta[:m].reshape(H, N)
            dq = delta[m:].reshape(H, N)
            for alpha in alphas:
                wt = w + alpha * dw
                qt = q + alpha * dq
                Rwt, Rpt, _mt = residual(wt, qt)
                rt = norm(Rwt, Rpt)
                if np.isfinite(rt) and rt < res_best:
                    w_best, q_best, res_best = wt, qt, rt
                    break   # largest improving step for this delta
        return res_best, w_best, q_best

    Rw, Rp, marg = residual(w, q)
    res = norm(Rw, Rp)
    for _ in range(rounds):
        if not np.isfinite(res) or res < ld(1e-16):
            break
        eps0 = min(kink_scale * res, ld(1e-3))
        w_best, q_best, res_best = w, q, res
        rhs = -np.concatenate([Rw.ravel(), Rp.ravel()])
        for eps in (ld(0), -eps0, eps0):
            res_best, w_best, q_best = try_masks(
                masks_of(marg, eps), rhs, w, q, res_best, w_best, q_best
            )
        if res_best >= res * ld(0.999999999):
            # Blanket EXPAND/SHRINK elements exhausted: the remaining stall
            # (the maximal-tie class) needs a SUBSET of the tied kink
            # components to flip. Greedy single-kink flips: try the
            # near-kink coordinates one at a time and keep the best
            # iterate; the outer loop repeats while progress continues.
            base = masks_of(marg, ld(0))
            cands = []
            for fam, margin in (("a", marg["mw"]), ("s", marg["ms"]),
                                ("act", marg["ma"])):
                am = np.abs(np.asarray(margin, np.float64))
                for t, i in np.argwhere(am < float(eps0)):
                    cands.append((am[t, i], fam, int(t), int(i)))
            cands.sort()
            for _score, fam, t, i in cands[:48]:
                mk = {k: (v.copy() if hasattr(v, "copy") else v)
                      for k, v in base.items()}
                mk[fam][t, i] = 1.0 - mk[fam][t, i]
                res_best, w_best, q_best = try_masks(
                    mk, rhs, w, q, res_best, w_best, q_best
                )
                if res_best < res * ld(0.5):
                    break        # a flip broke the stall; go on with
                                 # fresh margins in the outer round
        if verbose:
            print(f"  ext round: res {float(res):.3e} -> "
                  f"{float(res_best):.3e}", flush=True)
        if res_best >= res * ld(0.999999999):
            break
        w, q, res = w_best, q_best, res_best
        Rw, Rp, marg = residual(w, q)

    return np.asarray(w, np.float64), np.asarray(q, np.float64)


# ---------------------------------------------------------------------------
# The polish and the verified solve
# ---------------------------------------------------------------------------


def _fixed_point_steps(r, params):
    """(tau, sigma) [..., 1, 1] of the certified fixed-point map: the
    uniform Condat-Vu steps from the gross returns ``r`` [..., H, N]."""
    r_norm2 = (r * r).sum(dim=-1)
    r_min = r.amin(dim=-1)
    L = (r_norm2 / torch.clamp(r_min, min=1e-12) ** 2).amax(dim=-1)
    L = L[..., None, None] + params.ridge
    sigma = params.sigma_scale * torch.sqrt(L) / 2.0
    tau = params.step_scale / (0.5 * L + sigma * 4.0)
    return tau, sigma


def _residual_and_margins(w, p, r, w_init, tau, sigma, params):
    """The fixed-point residual (R_w, R_p) at (w, p) and the kink margins
    of its generalized Jacobian (with the portfolio returns ``port``)."""
    port = (w * r).sum(dim=-1, keepdim=True)
    grad = -r / torch.clamp(port, min=1e-12) + params.ridge * w
    vw = w - tau * (grad + _apply_Dt(p))
    Pw, mw = _proj_simplex_with_margin(vw)
    vp = p + sigma * _apply_D(w, w_init)
    Qp, dmarg = _Q_with_margins(vp, sigma, params.cost_coeff,
                                params.max_turnover)
    return w - Pw, p - Qp, {"mw": mw, "port": port, **dmarg}


def _masks_from_margins(margins, eps, tau_to):
    """The Jacobian masks (a, s, act, sgn, outside, port): eps = 0 the
    nominal one-sided B-subdifferential element; -e / +e the EXPAND /
    SHRINK elements at near-kink components."""
    a = (margins["mw"] > eps).to(margins["mw"].dtype)
    s, act, sgn, outside = _dual_masks(margins, eps, tau_to)
    return (a, s, act, sgn, outside, margins["port"])


def _jac_apply(masks, xw, xp, r, tau, sigma, ridge):
    """Apply the full Jacobian J to (xw, xp) (any extra leading axes)."""
    a, s, act, sgn, outside, port = masks
    # d vw = xw - tau (Hg xw + D' xp), Hg x = (r r' / port^2) x + ridge x
    coeff = (r * xw).sum(dim=-1, keepdim=True) \
        / torch.clamp(port, min=1e-12) ** 2
    dvw = xw - tau * (r * coeff + ridge * xw + _apply_Dt(xp))
    Jw = xw - _apply_P_jac(a, dvw)
    # d vp = xp + sigma D xw ; Q' dvp = dvp - B'(dvp)
    dvp = xp + sigma * _apply_D(xw, torch.zeros_like(xw[..., 0, :]))
    Jp = xp - (dvp - _apply_B_jac(s, act, sgn, outside, dvp))
    return Jw, Jp


def _dense_jacobian(masks, r, tau, sigma, ridge):
    """J [..., 2m, 2m] (rows the outputs (R_w, R_p), columns the inputs
    (w, p), each flattened), from its action on the [2m] identity basis as
    one batched call over an extra leading axis."""
    H, N = r.shape[-2:]
    m = H * N
    batch_shape = tuple(r.shape[:-2])
    eye = torch.eye(2 * m, dtype=r.dtype, device=r.device)
    full = (2 * m,) + batch_shape + (H, N)
    one = (2 * m,) + (1,) * len(batch_shape) + (H, N)
    ew = eye[:, :m].reshape(one).expand(full)
    ep = eye[:, m:].reshape(one).expand(full)
    Jw, Jp = _jac_apply(masks, ew, ep, r, tau, sigma, ridge)
    cols = torch.cat([Jw.reshape(full[:-2] + (m,)),
                      Jp.reshape(full[:-2] + (m,))], dim=-1)  # [2m, ..., 2m]
    return torch.movedim(cols, 0, -1)          # [..., 2m(out), 2m(in)]


def polish_log_utility(
    w: torch.Tensor,
    p: torch.Tensor,
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    params: MPCParams,
    num_newton: int = 4,
    damping: float = 1e-7,
    kink_aware: bool = True,
    kink_scale: float = 3.0,
    timer=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Damped semismooth-Newton refinement of a PDHG iterate, batched on the
    tensors' device in their dtype.

    Args:
        w, p: primal/dual iterates [..., H, N] from the PDHG solver.
        current_weights: [..., N]; predicted_log_returns: [..., H, N].
        kink_aware: (a) an ACTIVE-SET NEWTON candidate before the
            semismooth rounds (_active_set_newton), and (b) per Newton
            round, the EXPAND/SHRINK B-subdifferential elements (margins
            within ``kink_scale * residual`` of a kink flipped to the other
            side) and, in the stall regime, a minimum-norm step, keeping
            the per-problem best step.
        timer: a ``utils.profiler.StageTimer`` for the stages
            "active_set" and "svd", or None.
    Returns:
        (w_polished, info): per-problem ``residual_before/after``, an
        ``accepted`` mask, ``info['dual']`` (the polished dual iterate, for
        a warm-started continuation) and ``info['w_iterate']`` (the
        pre-projection Newton iterate that ``residual_after`` describes).
        Rejected problems keep their input w and p exactly.
    """
    H, N = predicted_log_returns.shape[-2:]
    m = H * N
    dtype = predicted_log_returns.dtype
    batch_shape = predicted_log_returns.shape[:-2]

    r = torch.exp(predicted_log_returns)
    w_init = current_weights.to(dtype)
    tau, sigma = _fixed_point_steps(r, params)
    tau_to = params.max_turnover

    def residual_and_margins(w, p):
        return _residual_and_margins(w, p, r, w_init, tau, sigma, params)

    def masks_from_margins(margins, eps):
        return _masks_from_margins(margins, eps, tau_to)

    def dense_J(masks):
        return _dense_jacobian(masks, r, tau, sigma, params.ridge)

    def res_norm(Rw, Rp):
        return torch.sqrt((Rw ** 2).sum(dim=(-2, -1))
                          + (Rp ** 2).sum(dim=(-2, -1)))

    def flat_rhs(Rw, Rp):
        return -torch.cat([Rw.reshape(batch_shape + (m,)),
                           Rp.reshape(batch_shape + (m,))], dim=-1)

    def newton_delta_minnorm(masks, Rw, Rp):
        """Min-norm semismooth step on the UNDAMPED nominal Jacobian.

        The weak-complementarity stall (turnover ball exactly active with
        kappa = 0): every B-subdifferential element is singular along the
        boundary-degenerate direction, so the damped solve's step is
        floor-limited at ~lam and the residual parks at 1e-10..1e-7. The
        pseudo-inverse step moves only in range(J), where the residual
        lives near the solution manifold. Only taken in the stall regime
        (a host gate in the Newton loop): one batched SVD per round.
        """
        delta = _pinv_solve(dense_J(masks), flat_rhs(Rw, Rp), 1e-12,
                            timer=timer)
        return (delta[..., :m].reshape(w.shape),
                delta[..., m:].reshape(p.shape))

    def newton_delta(masks, Rw, Rp, res):
        J = dense_J(masks)
        # Residual-scaled Levenberg damping: a fixed lambda caps the
        # achievable residual at ~lambda/sigma_min on degenerate faces;
        # shrinking it with the residual restores superlinear convergence
        # while keeping early far-from-solution steps damped.
        lam = torch.clamp(0.1 * res, max=damping)[..., None, None]
        Jd = J + lam * torch.eye(2 * m, dtype=dtype, device=J.device)
        # solve_ex: a singular system gives a non-finite step, which the
        # line search rejects (no host synchronisation on its status).
        delta = torch.linalg.solve_ex(Jd, flat_rhs(Rw, Rp)[..., None])[0]
        delta = delta[..., 0]
        return (delta[..., :m].reshape(w.shape),
                delta[..., m:].reshape(p.shape))

    def take_better(cur_w, cur_p, res_cur, cand_w, cand_p):
        Rw_c, Rp_c, _ = residual_and_margins(cand_w, cand_p)
        res_c = res_norm(Rw_c, Rp_c)
        better = torch.isfinite(res_c) & (res_c < res_cur)
        sel = better[..., None, None]
        return (torch.where(sel, cand_w, cur_w),
                torch.where(sel, cand_p, cur_p), better)

    accepted_any = torch.zeros(batch_shape, dtype=torch.bool, device=r.device)
    Rw0, Rp0, _ = residual_and_margins(w, p)
    res0 = res_norm(Rw0, Rp0)

    w_cur, p_cur = w, p
    if kink_aware:
        # Active-set Newton candidate first: exact KKT solve on the pattern
        # guessed from the PDHG iterate; the residual acceptance certifies
        # it, wrong guesses lose the comparison, and the semismooth rounds
        # finish off its point when the inner Newton stopped at ~1e-8.
        with _stage(timer, "active_set", w):
            w_as, p_as = _active_set_newton(w_cur, p_cur, r, w_init, params,
                                            timer=timer)
        w_cur, p_cur, better = take_better(w_cur, p_cur, res0, w_as, p_as)
        accepted_any = accepted_any | better

    for _ in range(num_newton):
        Rw, Rp, margins = residual_and_margins(w_cur, p_cur)
        res = res_norm(Rw, Rp)

        # Candidate Newton steps: the nominal one-sided element, and where
        # kink-aware the EXPAND / SHRINK elements that flip every margin
        # within eps = kink_scale * res of its kink (their steps cross the
        # kink); the per-problem acceptance keeps the lowest residual.
        if kink_aware:
            eps = torch.clamp(kink_scale * res, max=1e-3)[..., None, None]
            eps_list = [torch.zeros_like(eps), -eps, eps]
        else:
            eps_list = [torch.zeros_like(res)[..., None, None]]
        cands = [
            newton_delta(masks_from_margins(margins, e), Rw, Rp, res)
            for e in eps_list
        ]
        if kink_aware and bool(((res > 1e-13) & (res < 1e-5)).any()):
            # Stall regime present: add the min-norm pseudo-inverse step.
            cands.append(newton_delta_minnorm(
                masks_from_margins(margins, eps_list[0]), Rw, Rp))

        # Branch-free backtracking: the residual at a fixed ladder of step
        # sizes for every candidate, keeping the per-problem best.
        res_best = res
        w_best, p_best = w_cur, p_cur
        for dw, dp in cands:
            for alpha in (1.0, 0.5, 0.25, 0.125, 0.0625):
                w_try = w_cur + alpha * dw
                p_try = p_cur + alpha * dp
                Rw_t, Rp_t, _ = residual_and_margins(w_try, p_try)
                res_t = res_norm(Rw_t, Rp_t)
                better = torch.isfinite(res_t) & (res_t < res_best)
                sel = better[..., None, None]
                w_best = torch.where(sel, w_try, w_best)
                p_best = torch.where(sel, p_try, p_best)
                res_best = torch.where(better, res_t, res_best)
        accepted_any = accepted_any | (res_best < res)
        w_cur, p_cur = w_best, p_best

    if kink_aware and not bool(
            (res_norm(*residual_and_margins(w_cur, p_cur)[:2]) < 1e-13).all()):
        # Second active-set attempt from the post-semismooth point: the
        # Newton rounds often settle a cleaner pattern than the raw PDHG
        # iterate. Skipped when every problem is at certificate precision.
        Rw_c, Rp_c, _ = residual_and_margins(w_cur, p_cur)
        res_c = res_norm(Rw_c, Rp_c)
        with _stage(timer, "active_set", w):
            w_as, p_as = _active_set_newton(w_cur, p_cur, r, w_init, params,
                                            timer=timer)
        w_cur, p_cur, better = take_better(w_cur, p_cur, res_c, w_as, p_as)
        accepted_any = accepted_any | better

    # The final projection maps the polished iterate back to a primal
    # feasible point; problems where every step was rejected keep their
    # INPUT w exactly (an extra PDHG half-step would discard the caller's
    # turnover restoration without improving the residual).
    port = (w_cur * r).sum(dim=-1, keepdim=True)
    grad = -r / torch.clamp(port, min=1e-12) + params.ridge * w_cur
    vw = w_cur - tau * (grad + _apply_Dt(p_cur))
    w_proj, _ = _proj_simplex_with_jac(vw)
    acc = accepted_any[..., None, None]
    w_out = torch.where(acc, w_proj, w)
    p_out = torch.where(acc, p_cur, p)

    Rw_f, Rp_f, _ = residual_and_margins(w_cur, p_cur)
    info = {
        "residual_before": res0,
        "residual_after": res_norm(Rw_f, Rp_f),
        "accepted": accepted_any,
        "dual": p_out,
        # The PRE-projection Newton iterate: the point residual_after
        # describes; the extended-precision stage continues from it.
        "w_iterate": torch.where(acc, w_cur, w),
    }
    return w_out, info


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _put(t: torch.Tensor, i: int, row: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its i-th instance replaced by ``row`` [1, ...]."""
    out = t.clone()
    out[i] = row[0]
    return out


def solve_mpc_log_utility_batch_polished(
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    params: MPCParams,
    cycles: int = 3,
    continue_iters: Optional[int] = None,
    timer=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Verified solve: PDHG, then float64 (PDHG <-> Newton) alternation.

    The verification path that ``cfg.MPC.SOLVER.POLISH=True`` selects (via
    ``MPCParams.polish``). The batched PDHG solve runs as usual, in the
    caller's dtype on the caller's device; then, in float64 on the same
    device, the iterate alternates ``cycles`` rounds of semismooth-Newton
    polish and warm-started PDHG continuation (each continuation
    re-identifies the active set and hands the next Newton round a closer
    point). Instances still uncertified go through the tail loop (device),
    the boundary refinement (host), a deep float64 continuation (device),
    the interior-point fallback (host, then polished on the device) and the
    extended-precision polish (host), each accepted only where it lowers
    the certificate residual.

    Returns float64 weights on the inputs' device (turnover-restored when
    ``params.restore_feasibility``) and an info dict: the first solve's
    info updated with the final polish's ``residual_before/after``,
    ``accepted``, ``dual`` and ``w_iterate``, and ``objective``,
    ``converged``, ``turnover_violation`` recomputed from the POLISHED
    iterate, ``status_code`` banded on ``residual_after``
    (``fixed_point_residual`` remains the first solve's). ``timer``: a
    ``utils.profiler.StageTimer`` that receives the time of each stage. On
    a card every PDHG loop replays a CUDA graph of GRAPH_CHUNK iterations
    (``ops.mpc.graph_replayed``: the same kernels on the same values).
    """
    replay = (graph_replayed(GRAPH_CHUNK * max(1, params.adapt_every))
              if predicted_log_returns.is_cuda else contextlib.nullcontext())
    with replay:
        return _batch_polished(current_weights, predicted_log_returns,
                               params, cycles, continue_iters, timer)


def _batch_polished(current_weights, predicted_log_returns, params, cycles,
                    continue_iters, timer):
    # This function honours params.polish; the inner batch solves must not
    # see the flag (they refuse it, reject_unhonored_polish).
    params = replace(params, polish=False)
    shape = predicted_log_returns.shape
    batch_shape = shape[:-2]
    H, N = shape[-2:]
    cw_in = current_weights.reshape(-1, N)
    y_in = predicted_log_returns.reshape(-1, H, N)
    dev = y_in.device
    with _stage(timer, "first_solve", y_in):
        w, info = solve_mpc_log_utility_batch(cw_in, y_in, params)
    f64 = torch.float64
    cw64 = cw_in.to(f64)
    y64 = y_in.to(f64)
    w_cur = w.to(f64)
    p_cur = info["dual"].to(f64)
    if continue_iters is None:
        continue_iters = max(500, params.max_iters // 2)
    cont = replace(params, max_iters=continue_iters)
    nb = y64.shape[0]

    def certified_all(res, bar):
        return bool((res < bar).all())

    def stragglers(res, cap):
        """Indices (on the device) of the instances above 1e-11, when there
        are some and no more than ``cap``; else None."""
        bad = torch.nonzero(res > 1e-11).flatten()
        return bad if 0 < bad.numel() <= cap else None

    pol_info = None
    w_it = w_cur    # the pre-projection Newton iterate (the extended stage's)
    for cycle in range(max(1, cycles)):
        with _stage(timer, "newton", y64):
            w_cur, pol_info = polish_log_utility(
                w_cur, p_cur, cw64, y64, params,
                num_newton=params.polish_newton, timer=timer,
            )
        w_it = pol_info["w_iterate"]
        # Thread the Newton rounds' dual progress into the continuation.
        p_cur = pol_info["dual"]
        # Every problem at certificate precision: further cycles can only
        # re-confirm it.
        if certified_all(pol_info["residual_after"], 1e-13):
            break
        if cycle + 1 < cycles:
            with _stage(timer, "continuation", y64):
                w_cur, cinfo = solve_mpc_log_utility_batch(
                    cw64, y64, cont, w_warm=w_cur, p_warm=p_cur
                )
            p_cur = cinfo["dual"]

    def improved(pol_info, new_res):
        out = dict(pol_info)
        out["residual_after"] = new_res
        out["dual"] = p_cur
        out["accepted"] = pol_info["accepted"] | (
            new_res < pol_info["residual_before"])
        return out

    # TAIL REFINEMENT: instances parked above certificate precision after
    # the main cycles sit at weak-complementarity kinks where the Newton
    # rounds converge linearly; they need more focused rounds. The tail loop
    # takes the uncertified subset (index tensors on the device),
    # alternates polish <-> warm PDHG on it and scatters the results back.
    flat_res = pol_info["residual_after"]
    bad = stragglers(flat_res, max(1, nb // 4))
    if bad is not None:
        with _stage(timer, "tail", y64):
            w_b, p_b = w_cur[bad], p_cur[bad]
            cw_b, y_b = cw64[bad], y64[bad]
            for t in range(4):
                if t > 0:
                    # Warm PDHG re-identification between Newton rounds; the
                    # loop always ENDS on a polish so the reported residual
                    # describes the returned iterate.
                    w_b, cinfo = solve_mpc_log_utility_batch(
                        cw_b, y_b, cont, w_warm=w_b, p_warm=p_b)
                    p_b = cinfo["dual"]
                w_b, tinfo = polish_log_utility(
                    w_b, p_b, cw_b, y_b, params,
                    num_newton=2 * params.polish_newton, timer=timer,
                )
                p_b = tinfo["dual"]
                res_b = tinfo["residual_after"]
                if certified_all(res_b, 1e-13):
                    break
            w_cur = w_cur.index_copy(0, bad, w_b)
            p_cur = p_cur.index_copy(0, bad, p_b)
            w_it = w_it.index_copy(0, bad, tinfo["w_iterate"])
            new_res = flat_res.index_copy(0, bad, res_b)
            pol_info = dict(pol_info)
            pol_info["residual_after"] = new_res
            pol_info["dual"] = p_cur
            # 'accepted' marks every instance whose returned residual
            # improved on the pre-polish one; 'residual_before' refers to
            # the LAST main-loop polish input.
            imp = flat_res.index_copy(0, bad,
                                      torch.minimum(res_b, flat_res[bad]))
            pol_info["accepted"] = pol_info["accepted"] | (
                imp < pol_info["residual_before"])

    cw_np = _host(cw64)
    y_np = _host(y64)
    r_np = np.exp(y_np)

    # BOUNDARY REFINEMENT: instances still uncertified sit on combinatorial
    # boundary degeneracies the iterate cannot resolve (the dust positions'
    # sell dates, see _boundary_refine_instance). Cheap per instance, so
    # the gate only caps pathological all-bad batches.
    bad = stragglers(pol_info["residual_after"], max(16, nb // 4))
    if bad is not None:
        with _stage(timer, "boundary", y64):
            new_res = _host(pol_info["residual_after"]).copy()
            wf, pf, wi = _host(w_cur).copy(), _host(p_cur).copy(), \
                _host(w_it).copy()
            for b in _host(bad).tolist():
                out = _boundary_refine_instance(wf[b], pf[b], cw_np[b],
                                                y_np[b], params)
                if out is not None and out[2] < new_res[b]:
                    # The refined (w, q) pair IS the point new_res
                    # describes: it is also the iterate.
                    wf[b], pf[b], wi[b] = out[0], out[1], out[0]
                    new_res[b] = out[2]
            w_cur, p_cur, w_it = (torch.as_tensor(a, device=dev)
                                  for a in (wf, pf, wi))
            pol_info = improved(pol_info, torch.as_tensor(new_res, device=dev))

    # LONG float64 CONTINUATION: before the expensive pattern-free
    # fallbacks, a deep warm-started PDHG run per straggler in
    # 100k-iteration chunks. The decay on the tie class is
    # flat-flat-CLIFF (the tied micro active set settles, then the
    # iteration converges at machine rate), so the chunks run past the
    # plateau; a floor that moves < 20% across three consecutive chunks is
    # the no-watershed class, and stops. The stragglers still running take
    # each chunk together, in one batched solve (the problems are
    # independent; each keeps its own stopping rule).
    bad = stragglers(pol_info["residual_after"], max(16, nb // 4))
    if bad is not None:
        with _stage(timer, "deep_continuation", y64):
            new_res = _host(pol_info["residual_after"]).copy()
            deep = replace(params, max_iters=100_000)
            runs = {b: {"w": w_it[b], "p": p_cur[b], "res": new_res[b],
                        "prev": np.inf, "flat": 0}
                    for b in _host(bad).tolist()}
            live = list(runs)
            for _chunk in range(10):
                idx = torch.as_tensor(live, device=dev)
                w_c, cinfo3 = solve_mpc_log_utility_batch(
                    cw64[idx], y64[idx], deep,
                    w_warm=torch.stack([runs[b]["w"] for b in live]),
                    p_warm=torch.stack([runs[b]["p"] for b in live]))
                for k, b in enumerate(live):
                    runs[b]["w"], runs[b]["p"] = w_c[k], cinfo3["dual"][k]
                for b in list(live):
                    run = runs[b]
                    run["res"] = _pair_residual(
                        _host(run["w"]), _host(run["p"]), r_np[b],
                        cw_np[b], params)
                    if run["res"] < 1e-12:
                        live.remove(b)
                        continue
                    if run["res"] > 0.8 * run["prev"]:
                        run["flat"] += 1
                        if run["flat"] >= 3:
                            live.remove(b)
                            continue
                    else:
                        run["flat"] = 0
                    run["prev"] = run["res"]
                if not live:
                    break
            for b, run in runs.items():
                if np.isfinite(run["res"]) and run["res"] < new_res[b]:
                    w_cur = _put(w_cur, b, run["w"][None])
                    p_cur = _put(p_cur, b, run["p"][None])
                    w_it = _put(w_it, b, run["w"][None])
                    new_res[b] = run["res"]
            pol_info = improved(pol_info, torch.as_tensor(new_res, device=dev))

    # INTERIOR-POINT FALLBACK: the pattern-free last resort. The barrier
    # solve (host) needs no active-set guess and lands at the analytic
    # centre, from which the polish (device) finishes superlinearly.
    bad = stragglers(pol_info["residual_after"], max(16, nb // 4))
    if bad is not None:
        with _stage(timer, "interior_point", y64):
            new_res = _host(pol_info["residual_after"]).copy()
            for bdx in _host(bad).tolist():
                ip = _interior_point_instance(cw_np[bdx], y_np[bdx], params)
                if ip is None:
                    continue
                w_ip = torch.as_tensor(ip[0][None], device=dev)
                p_ip = torch.as_tensor(ip[1][None], device=dev)
                one = slice(bdx, bdx + 1)
                # Polish <-> warm-PDHG alternation from the IP point.
                for t in range(3):
                    w_ip, ipinfo = polish_log_utility(
                        w_ip, p_ip, cw64[one], y64[one], params,
                        num_newton=params.polish_newton, timer=timer,
                    )
                    p_ip = ipinfo["dual"]
                    r_ip = float(ipinfo["residual_after"][0])
                    if r_ip < 1e-13:
                        break
                    if t < 2:
                        w_ip, cinfo2 = solve_mpc_log_utility_batch(
                            cw64[one], y64[one], cont,
                            w_warm=w_ip, p_warm=p_ip)
                        p_ip = cinfo2["dual"]
                if np.isfinite(r_ip) and r_ip < new_res[bdx]:
                    w_cur = _put(w_cur, bdx, w_ip)
                    p_cur = _put(p_cur, bdx, p_ip)
                    w_it = _put(w_it, bdx, ipinfo["w_iterate"])
                    new_res[bdx] = r_ip
            pol_info = improved(pol_info, torch.as_tensor(new_res, device=dev))

    # EXTENDED-PRECISION POLISH: the arithmetic last resort for the
    # tie-class attractor (a float64 conditioning floor), from the
    # PRE-projection Newton iterate (the point residual_after describes).
    bad = stragglers(pol_info["residual_after"], max(16, nb // 4))
    if bad is not None:
        with _stage(timer, "extended", y64):
            new_res = _host(pol_info["residual_after"]).copy()
            wf, pf, wi = _host(w_cur).copy(), _host(p_cur).copy(), \
                _host(w_it)
            for bdx in _host(bad).tolist():
                out = _extended_polish_instance(wi[bdx], pf[bdx], cw_np[bdx],
                                                y_np[bdx], params)
                if out is None:
                    continue
                r_x = _pair_residual(out[0], out[1], r_np[bdx], cw_np[bdx],
                                     params)
                if np.isfinite(r_x) and r_x < new_res[bdx]:
                    wf[bdx], pf[bdx] = out
                    new_res[bdx] = r_x
            w_cur = torch.as_tensor(wf, device=dev)
            p_cur = torch.as_tensor(pf, device=dev)
            pol_info = improved(pol_info, torch.as_tensor(new_res, device=dev))
    w_pol = w_cur

    # The diagnostics the caller reads, recomputed from the POLISHED
    # iterate, and the exact turnover restoration re-applied so that the
    # ``restore_feasibility`` contract holds for the returned weights too
    # (the polish tail projects to the simplex only).
    tau_to = params.max_turnover
    if tau_to > 0:
        u_pre = _apply_D(w_pol, cw64)
        to_viol = torch.clamp(u_pre.abs().sum(dim=-1) - tau_to,
                              min=0.0).amax(dim=-1)
        if params.restore_feasibility:
            w_pol = restore_turnover_feasibility(w_pol, cw64, tau_to)
    else:
        to_viol = torch.zeros(w_pol.shape[:-2], dtype=w_pol.dtype, device=dev)
    finite = torch.isfinite(w_pol).all(dim=-1).all(dim=-1) & torch.isfinite(
        pol_info["residual_after"])
    if tau_to > 0 and params.restore_feasibility:
        converged = finite
    else:
        converged = finite & (to_viol <= params.feas_tol)
    objective = _log_utility_objective(w_pol, torch.exp(y64), cw64,
                                       params.cost_coeff)
    out_info = dict(info)
    out_info.update(pol_info)     # incl. the polished dual
    out_info["objective"] = objective
    out_info["converged"] = converged
    out_info["turnover_violation"] = to_viol
    # Status bands on the POLISH residual (the returned iterate's
    # convergence measure), not the discarded first solve's.
    out_info["status_code"] = _status_code(pol_info["residual_after"],
                                           params.feas_tol)
    out_info = {k: v.reshape(batch_shape + v.shape[1:])
                for k, v in out_info.items()}
    return w_pol.reshape(shape), out_info
