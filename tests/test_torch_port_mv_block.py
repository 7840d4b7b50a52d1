"""The fifth slice of kmpc_tpu_torch against kmpc_tpu: kernel C (the
mean-variance solve) past one warp's registers, which the port solves in its
block-per-problem kernels (``csrc/pdhg_mean_variance_block{,_adaptive}.cu``,
C.2): the plain version against kmpc_tpu's Pallas kernel at those shapes,
the routing of every shape kmpc_tpu's wrapper sends to its Pallas kernel,
the block layout's shared-memory plan, the float32 limit of the adaptive
body at N=960, and chip_smoke.py's bars for the problems it leaves
unsettled (held against the plain version in float64).

The JAX reference is the Pallas wrapper in interpret mode on the CPU, as
tests/test_torch_port_kernels.py runs it; the port runs the kernels' plain
version through its CPU entry point (on the CPU a wrapper takes the plain
version only because the tensor lies there; both layouts share it). Inputs
are made with numpy from a seed.

Bars (the repository's mean-variance kernel-vs-XLA bars): weights and the
fixed-point residual <= 5e-5, objective <= 1e-6, equal ``converged``.
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmpc_tpu.ops import mpc_pallas as JP
from kmpc_tpu.ops.mpc import MPCParams as JParams
from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams

MV_W_TOL, MV_OBJ_TOL = 5e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs many small CPU operations, which torch's thread
    pool slows by an order of magnitude when other processes share the
    cores (the suite runs files in parallel); one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, "gamma": 5.0, **kw})


def _inputs(B, H, N, seed, shared, scale=0.05):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N) if shared else (B, N, N)) * scale
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4
    # A slightly asymmetric input: the wrappers symmetrise it first.
    sig = sig + 1e-5 * np.triu(np.ones((N, N)), 1)
    return cw, mu, sig.astype(np.float32)


# ---------------------------------------------------------------------------
# The plain version against kmpc_tpu's Pallas kernel at C.2 shapes
# ---------------------------------------------------------------------------

# name: (B, H, N, shared Sigma, params)
CASES = {
    "H17N12": (4, 17, 12, False, dict(max_iters=400)),
    "H5N70_refresh": (3, 5, 70, False, dict(max_iters=400,
                                            proj_refresh_every=16)),
    "H1N136_shared": (4, 1, 136, True, dict(max_iters=400)),
    "H20N20_shared": (4, 20, 20, True, dict(max_iters=400)),
    "H9N40_adaptive_k2": (4, 9, 40, False, dict(
        max_iters=400, adaptive=True, adapt_every=2)),
    "H17N10_shared_adaptive_k2": (4, 17, 10, True, dict(
        max_iters=400, adaptive=True, adapt_every=2)),
    "H17N12_over_relax": (4, 17, 12, False, dict(max_iters=400,
                                                 over_relax=1.5)),
    "H17N12_cold_proj": (4, 17, 12, False, dict(max_iters=300,
                                                proj_warm_iters=0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_block_shapes_match_pallas(name):
    B, H, N, shared, kw = CASES[name]
    # Past the warp layout: every one of these (H <= 32) routes to the tile
    # layout, and the block layout keeps H > 32.
    assert V.mv_kernel_layout(H, N, shared, kw.get("adaptive", False)) \
        == "tile"
    cw, mu, sig = _inputs(B, H, N, 301 + H + N, shared)
    w_ref, info_ref = JP.solve_mpc_mean_variance_pallas_packed(
        jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
        _params(kw, JParams), interpret=True)
    w, info = V.solve_mpc_mean_variance_packed(
        _t(cw), _t(mu), _t(sig), _params(kw), device="cpu")
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=MV_W_TOL,
                               rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], atol=MV_OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"].numpy(),
                               info_ref["fixed_point_residual"],
                               atol=MV_W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])
    w64 = w.double().numpy()
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= 1e-5) and np.all(w64 >= 0)


# ---------------------------------------------------------------------------
# Routing: every shape kmpc_tpu's wrapper sends to its kernel has a layout
# ---------------------------------------------------------------------------

HS = [1, 2, 4, 5, 8, 9, 16, 17, 20, 40, 100, 340]
NS = [1, 8, 9, 16, 20, 30, 32, 33, 40, 56, 64, 65, 72, 80, 88, 96, 104,
      112, 120, 121, 128, 129, 136, 200, 256, 320, 336, 344, 480, 488, 976,
      984, 1112, 1120, 1200]


class _Kernel(Exception):
    pass


class _Fallback(Exception):
    pass


def _pallas_takes(H, N, shared, adaptive):
    """Whether kmpc_tpu's ``solve_mpc_mean_variance_pallas_packed`` builds
    its Pallas kernel for this shape (else it hands the solve to its XLA
    solver): traced with abstract inputs, stopped at either."""
    p = JParams(max_iters=10, gamma=5.0, adaptive=adaptive, adapt_every=2)
    B = 2
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (B, N), (B, H, N), (N, N) if shared else (B, N, N))]
    try:
        jax.eval_shape(
            lambda a, b, c: JP.solve_mpc_mean_variance_pallas_packed(
                a, b, c, p), *args)
    except _Kernel:
        return True
    except _Fallback:
        return False
    raise AssertionError("the wrapper neither built its kernel nor fell back")


@pytest.mark.parametrize("shared", [False, True])
def test_every_shape_the_pallas_kernel_takes_routes_to_a_cuda_kernel(
        shared, monkeypatch):
    """Over a grid of (H, N) and both bodies, wherever kmpc_tpu's wrapper
    takes its Pallas kernel (read from the wrapper itself: a spy on
    ``_make_packed_mv_kernel``, and on the XLA solver it falls back to),
    ``mv_kernel_layout`` names a CUDA layout for one problem and for 1028:
    the lane layout every shape ``mv_kernel_supports`` gives the warp
    layout (one row up to 128 assets; the warp layout measured slower
    there and is launched only privately), the block
    layout the longer horizons and, at most 32 rows, only the shapes whose
    Sigma the tile layout would stream at fewer than TILE_STREAM_H rows (a
    shared one for at most 132 problems), the tile layout the rest. The
    envelope's edges show in the grid: per problem N=80 is the last at
    H=20 (64 adaptive), a shared Sigma N=1112 at H=1 (976 adaptive) and
    N=128 at H=20 (88 adaptive)."""
    import kmpc_tpu.ops.mpc as JM

    def kernel(*a, **k):
        raise _Kernel

    def fallback(*a, **k):
        raise _Fallback

    monkeypatch.setattr(JP, "_make_packed_mv_kernel", kernel)
    monkeypatch.setattr(JM, "solve_mpc_mean_variance_batch", fallback)
    taken, routed = {}, {"lanes": 0, "tile": 0, "block": 0}
    for H in HS:
        for N in NS:
            for adaptive in (False, True):
                taken[(H, N, adaptive)] = _pallas_takes(H, N, shared,
                                                        adaptive)
                for B in (1, 1028):
                    layout = V.mv_kernel_layout(H, N, shared, adaptive, B)
                    if V.mv_kernel_supports(H, N):
                        assert layout == "lanes", (H, N)
                    if not taken[(H, N, adaptive)]:
                        continue
                    assert layout in ("lanes", "tile", "block"), (
                        H, N, shared, adaptive, B)
                    streamed_few = (
                        V.mv_tile_streams(H, N, adaptive)
                        and H < V.TILE_STREAM_H
                        and not (shared and B > V.TILE_SMS))
                    assert (layout == "block") == (
                        H > V.TILE_MAX_WARPS or streamed_few), (
                        H, N, shared, adaptive, B, layout)
                    routed[layout] += 1
    assert all(routed.values()) and not all(taken.values())
    if shared:
        edges = [(1, 1112, 1120, False), (1, 976, 984, True),
                 (20, 128, 129, False), (20, 88, 96, True)]
    else:
        edges = [(20, 80, 88, False), (20, 64, 65, True)]
    for H, last, beyond, adaptive in edges:
        assert taken[(H, last, adaptive)], (H, last, adaptive)
        assert not taken[(H, beyond, adaptive)], (H, beyond, adaptive)


@pytest.mark.parametrize("H,N,floats,staged", [
    # 5 H N (w, p, mu, the projection and dual inputs) + N + H + 4
    # + (block_threads(N) / 32) * 2 H, and N * N where all of it fits.
    (20, 30, 5 * 600 + 30 + 20 + 4 + 1 * 40 + 900, True),
    (340, 8, 5 * 2720 + 8 + 340 + 4 + 1 * 680 + 64, True),
    (4, 120, 5 * 480 + 120 + 4 + 4 + 4 * 8 + 14400, True),
    (1, 220, 5 * 220 + 220 + 1 + 4 + 7 * 2 + 48400, True),
    (1, 239, 5 * 239 + 239 + 1 + 4 + 8 * 2, False),
    (1, 960, 5 * 960 + 960 + 1 + 4 + 16 * 2, False),
    (5, 320, 5 * 1600 + 320 + 5 + 4 + 10 * 10, False),
])
def test_block_shared_memory_plan(H, N, floats, staged):
    """``mv_block_smem_bytes`` against the kernel's plan (``mv_block_plan``
    in csrc/pdhg_mean_variance_block.cuh, counted here by hand; chip_smoke.py
    holds it against the value the built library reports), one plan for a
    per-problem and a shared covariance; Sigma is staged where the whole
    plan fits a block's shared memory, else read from global memory."""
    assert V.mv_sigma_staged(H, N) is staged
    assert V.mv_block_smem_bytes(H, N) == 4 * floats
    assert 4 * floats <= V.SMEM_PER_BLOCK


def test_a_cuda_solve_beyond_both_layouts_raises():
    """The route the CUDA wrapper takes before any launch: a shape whose
    iterates exceed a block's shared memory (and the tile plan's) raises
    ``ValueError`` naming the eager solver; the shape picks the layout,
    the parameters the body."""
    H, N = 20, 800
    assert V.mv_kernel_layout(H, N) is None
    assert V.mv_kernel_layout(H, N, shared=True) is None
    with pytest.raises(ValueError, match="solve_mpc_mean_variance_batch"):
        V._mv_route(H, N, MPCParams())
    assert V._mv_route(1, 20, MPCParams()) == (
        "lanes", V.PDHG_MEAN_VARIANCE_LANES)
    assert V._mv_route(20, 30, MPCParams(adaptive=True)) == (
        "tile", V.PDHG_MEAN_VARIANCE_TILE_ADAPTIVE)
    assert V._mv_route(1, 1112, MPCParams()) == (
        "block", V.PDHG_MEAN_VARIANCE_BLOCK)
    assert V._mv_route(1, 1112, MPCParams(), shared=True) == (
        "block", V.PDHG_MEAN_VARIANCE_BLOCK)
    assert V._mv_route(1, 1112, MPCParams(), shared=True, B=1028) == (
        "tile", V.PDHG_MEAN_VARIANCE_TILE)
    assert V._mv_route(40, 30, MPCParams(adaptive=True)) == (
        "block", V.PDHG_MEAN_VARIANCE_BLOCK_ADAPTIVE)
    with pytest.raises(ValueError, match="CUDA"):
        V.pdhg_mean_variance_cuda(torch.ones(2, N), torch.ones(2, H, N),
                                  torch.ones(N, N), MPCParams())


def test_the_eager_solver_ignores_graph_chunk_on_the_cpu():
    """``ops.mpc.graph_replayed`` replays the eager solvers' loop as CUDA
    graphs of a chunk of iterations (chip_smoke.py's float64 references,
    which it holds to the loop bit for bit on the card, and the polished
    path's PDHG loops); with that replay in place, CPU tensors run the loop
    itself, and the eager solver is as before after it."""
    from kmpc_tpu_torch.ops import mpc as M

    cw, mu, sig = _inputs(3, 2, 8, 5, False)
    p = _params(dict(max_iters=61, adaptive=True, adapt_every=2))
    eager = M._iterate
    a = M.solve_mpc_mean_variance_batch(_t(cw), _t(mu), _t(sig), p)
    with M.graph_replayed(20):
        assert M._iterate is not eager
        b = M.solve_mpc_mean_variance_batch(_t(cw), _t(mu), _t(sig), p)
    assert M._iterate is eager
    assert torch.equal(a[0], b[0])


# ---------------------------------------------------------------------------
# The adaptive body at N=960 is at float32's limit
# ---------------------------------------------------------------------------

def _wide_problems(B=128, N=960, seed=902):
    """bench.py's Markowitz problems at H=1 with one shared covariance
    (current weights, mu at scale 0.01, A A' + 1e-4 I with A at scale
    0.01), as chip_smoke.py's ``mv_long_wide`` draws them at N=960."""
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, 1, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N)) * 0.01
    sig = (A @ A.T + np.eye(N) * 1e-4).astype(np.float32)
    return cw, mu, sig


def test_adaptive_mean_variance_body_at_960_assets_is_at_float32s_limit():
    """The evidence for chip_smoke.py's rule for unsettled mean-variance
    problems (``hold_unsettled_mv``): at H=1, N=960, one shared covariance,
    1000 iterations, k=2, kmpc_tpu's own solver in float32, run on the
    problems as given and with the assets permuted (two float32
    realisations of one solver), ends
    more than 1e-4 apart in objective on some of 128 problems, one of the
    two unsettled there (fixed-point residual > 1e-3): once the residuals
    are rounding noise the balancing grows tau past what the covariance's
    spectrum allows. The fixed-step body settles everywhere and its two
    realisations agree within the objective bar."""
    from kmpc_tpu.ops.mpc import solve_mpc_mean_variance_batch as solve

    cw, mu, sig = _wide_problems()
    perm = np.random.default_rng(0).permutation(cw.shape[-1])
    adaptive = JParams(max_iters=1000, sigma_scale=2.0, gamma=5.0,
                       adaptive=True, adapt_every=2)
    fixed = JParams(max_iters=1000, sigma_scale=2.0, gamma=5.0,
                    proj_refresh_every=16)

    def run(p, order):
        w, info = jax.jit(lambda a, b, c: solve(a, b, c, p))(
            jnp.asarray(cw[:, order]), jnp.asarray(mu[..., order]),
            jnp.asarray(sig[np.ix_(order, order)]))
        return (np.asarray(info["objective"], np.float64),
                np.asarray(info["fixed_point_residual"]))

    natural = np.arange(cw.shape[-1])
    (o1, f1), (o2, f2) = run(adaptive, natural), run(adaptive, perm)
    parted = np.abs(o1 - o2) > 1e-4
    print({"parted": np.flatnonzero(parted).tolist(),
           "max_dobj": float(np.max(np.abs(o1 - o2))),
           "unsettled": int(np.sum(np.maximum(f1, f2) > 1e-3))})
    assert parted.any()
    assert np.any(np.maximum(f1, f2)[parted] > 1e-3)
    # The fixed-step body on the first 32 problems, the parted ones among
    # them or not.
    cw, mu = cw[:32], mu[:32]
    (o3, f3), (o4, f4) = run(fixed, natural), run(fixed, perm)
    assert max(f3.max(), f4.max()) <= 1e-6
    assert np.max(np.abs(o3 - o4)) <= MV_OBJ_TOL


def _chip_smoke():
    """chip_smoke.py as a module: its bars run on any device."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _standin(iters, fault=0.0, permuted=True, rows=None):
    """The plain version's outputs on two of the problems above at N=256
    (B=2, k=2) and a stand-in kernel's: the plain version with the assets
    permuted (another float32 realisation of the solver), or as it is, with
    ``fault`` of weight moved in each row of the problems ``rows`` (all by
    default) from its largest holding to its lowest forecast."""
    cw, mu, sig = _wide_problems(B=2, N=256)
    cw, mu = _t(cw), _t(mu)
    sig = _t(sig)
    sig = (0.5 * (sig + sig.T)).contiguous()
    p = _params(dict(max_iters=iters, adaptive=True, adapt_every=2))
    out_p = V.pdhg_mean_variance_plain(cw, mu, sig, p, return_steps=True)
    w, fp, steps = out_p
    if permuted:
        perm = torch.randperm(sig.shape[0],
                              generator=torch.Generator().manual_seed(0))
        w, fp, steps = V.pdhg_mean_variance_plain(
            cw[:, perm], mu[..., perm], sig[perm][:, perm].contiguous(), p,
            return_steps=True)
        w = w[..., torch.argsort(perm)]
    w = _move_weight(w, mu, fault, rows)
    return cw, mu, sig, p, (w, fp, steps), out_p


def _move_weight(w, mu, fault, rows=None):
    """``w`` with ``fault`` of weight moved in each row of the problems
    ``rows`` (all by default) from its largest holding to its lowest
    forecast."""
    step = torch.zeros(w.shape[0], 1, 1)
    step[slice(None) if rows is None else rows] = fault
    w = w.clone()
    w.scatter_add_(-1, w.argmax(-1, keepdim=True), -step)
    w.scatter_add_(-1, mu.argmin(-1, keepdim=True), step)
    return w


def test_float64_referee_holds_another_float32_realisation_of_the_mv_body():
    """chip_smoke.py's bars for an adaptive mean-variance case, on the CPU,
    with a stand-in kernel that is a correct float32 solver (the plain
    version with the assets permuted) at 1000 iterations: held, its step
    histories its own, every problem settled."""
    C = _chip_smoke()
    cw, mu, sig, p, out_k, out_p = _standin(1000)
    res = {}
    C.hold_mv("standin", cw, mu, sig, p, out_k, out_p, res)
    print(res)
    assert res["decisions_parted"] >= 1
    assert res["unsettled_apart"] == 0


def test_float64_referee_rejects_a_planted_mean_variance_fault():
    """The plain version's own run with 5e-4 of weight moved in every row
    (300 iterations, its step histories the plain version's): beyond the
    weight bar and 2e-5 from the plain version in objective with equal step
    histories, so the bars refuse it."""
    C = _chip_smoke()
    cw, mu, sig, p, out_k, out_p = _standin(300, fault=5e-4, permuted=False)
    with pytest.raises(AssertionError, match="equal step histories"):
        C.hold_mv("planted", cw, mu, sig, p, out_k, out_p, {})


def test_a_planted_fault_where_the_step_histories_parted_is_refused():
    """Another float32 realisation (1000 iterations) with 5e-4 of weight
    moved on a problem whose step histories parted from the plain
    version's: both sides settled there, so the objective bar holds and
    refuses it."""
    C = _chip_smoke()
    cw, mu, sig, p, out_k, out_p = _standin(1000)
    parted = torch.nonzero(out_k[2][:, -1] != out_p[2][:, -1]).flatten()
    assert parted.numel() >= 1
    assert float(torch.maximum(out_k[1], out_p[1]).max()) <= \
        C.MV_UNSETTLED_FP
    out_k = (_move_weight(out_k[0], mu, 5e-4, parted[:1]),) + out_k[1:]
    with pytest.raises(AssertionError, match="objectives differ"):
        C.hold_mv("planted_parted", cw, mu, sig, p, out_k, out_p, {})


def _unsettled_plain(fault_kernel):
    """A problem the plain version left unsettled, as the adaptive body
    leaves a few at N=960: the plain version's run at 300 iterations with
    1e-2 of weight moved on problem 0 and its fixed-point residual there
    set to 1e-2; the stand-in kernel is the plain version's own run, with
    ``fault_kernel`` of weight moved on problem 0."""
    cw, mu, sig, p, out_k, out_p = _standin(300, fault=fault_kernel,
                                            permuted=False, rows=[0])
    fp = out_p[1].clone()
    fp[0] = 1e-2
    out_p = (_move_weight(out_p[0], mu, 1e-2, [0]), fp, out_p[2])
    return cw, mu, sig, p, out_k, out_p


def test_a_settled_kernel_beside_an_unsettled_plain_problem_is_held():
    """Where the plain version did not settle and the kernel did, the
    kernel is held against the float64 run on that problem: within the
    objective bar of it, so held, and the other problem by the plain
    version's bars."""
    C = _chip_smoke()
    cw, mu, sig, p, out_k, out_p = _unsettled_plain(0.0)
    res = {}
    C.hold_mv("unsettled_plain", cw, mu, sig, p, out_k, out_p, res)
    print(res)
    assert res["unsettled_apart"] == 1
    assert (res["kernel_unsettled_apart"], res["plain_unsettled_apart"]) \
        == (0, 1)
    assert abs(res["unsettled"][0]["dobj_kernel_vs_float64"]) <= MV_OBJ_TOL


def test_a_faulty_settled_kernel_beside_an_unsettled_plain_is_refused():
    """The same problem with 5e-4 of weight moved in the kernel's answer
    too: the kernel settled there, so it must meet the objective bar
    against the float64 run, and does not."""
    C = _chip_smoke()
    cw, mu, sig, p, out_k, out_p = _unsettled_plain(5e-4)
    with pytest.raises(AssertionError, match="kernel settled"):
        C.hold_mv("unsettled_plain_fault", cw, mu, sig, p, out_k, out_p, {})


def test_a_settled_kernel_where_float64_does_not_settle_is_held_to_the_optimum():
    """Problem 259 of ``mv_long_wide``'s shared N=960 batch at bench.py's
    adaptive setting: the float64 adaptive run does not settle there
    (residual 2.9e-3 at 1000 iterations, on the card at 20000 too), the
    float64 run with fixed steps does (MV_REFEREE_ITERS iterations). A
    settled kernel at that optimum, beside an unsettled plain version, is
    held against the fixed-step run (the adaptive float64 iterate lies
    7e-5 below it in objective), and one 1e-5 below the optimum is
    refused."""
    C = _chip_smoke()
    cw, mu, sig = (torch.as_tensor(x) for x in C.mv_instance(
        1028, 1, 960, 902, True, scale=0.01))
    sig = (0.5 * (sig + sig.T)).contiguous()
    cw, mu = cw[259:260], mu[259:260]
    p = C.mv_settings()["adaptive"]

    def objective(q):
        w, fp = V.pdhg_mean_variance_plain(cw.double(), mu.double(),
                                           sig.double(), q)
        obj = V._finalize_mv(w, fp, mu.double(), sig.double(), cw.double(),
                             q)[1]["objective"]
        return fp, obj

    fp_ada, obj_ada = objective(p)
    fp_opt, obj_opt = objective(replace(
        p, adaptive=False, proj_refresh_every=0,
        max_iters=C.MV_REFEREE_ITERS))
    assert fp_ada.item() > C.MV_UNSETTLED_FP >= fp_opt.item()
    assert obj_opt.item() - obj_ada.item() > 5e-5
    astray = torch.tensor([True])
    fpk, fpp = torch.tensor([4e-9]), torch.tensor([2.9e-3])
    res = {}
    C.hold_unsettled_mv("referee", cw, mu, sig, p, astray, fpk, fpp,
                        obj_opt.float(), obj_ada.float(), res)
    assert res["float64_fixed_step_referee"] == 1
    assert (res["kernel_unsettled_apart"], res["plain_unsettled_apart"]) \
        == (0, 1)
    with pytest.raises(AssertionError, match="settled where the plain"):
        C.hold_unsettled_mv("planted", cw, mu, sig, p, astray, fpk, fpp,
                            obj_opt.float() - 1e-5, obj_ada.float(), {})
