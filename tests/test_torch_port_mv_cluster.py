"""The seventeenth slice of kmpc_tpu_torch against kmpc_tpu: kernel C (the
mean-variance solve) in the cluster layout.

The cluster layout (``csrc/pdhg_mean_variance_cluster{,_adaptive}.cu``,
``csrc/pdhg_mean_variance_cluster.cuh``) runs the block layout's body with
one problem's asset columns split over a thread-block cluster of up to 16
CTAs: w replicated in every CTA through distributed shared memory, each
warp's reduce partials written into every CTA and combined in the block
kernel's order, Sigma's own columns staged for as many rows as fit beside
the iterates and the rest read from L2. It takes the one-row shapes whose
covariance the block layout streams from device memory every iteration,
and the global layout's shapes that a cluster holds; the global layout
keeps the rest and ``allow_short``.

On the CPU: the plan (``mv_cluster_plan``: the CTAs, the threads and
column slots a CTA, the rows of Sigma staged and the bytes a CTA, counted
here by hand; chip_smoke.py holds them against the values the built library
reports), the routing of every mean-variance shape the port once refused
and of the global path's Markowitz shape, and the packed wrapper (the
kernels' plain version on the CPU) against kmpc_tpu's packed wrapper on the
same numpy inputs at cluster-routed shapes of each body, a covariance per
problem and one shared. On a card (marked ``cuda``, and skipped here): the
cluster kernels give the block kernel's bits at one row and the global
kernel's at H=20 N=1000, each at two cluster sizes. JAX is imported only
inside the comparisons, so that

    python -m pytest tests/test_torch_port_mv_cluster.py -m cuda --noconftest

runs the card's tests on a machine without it.

Bars (the repository's mean-variance kernel-vs-XLA bars): weights and the
fixed-point residual <= 5e-5, objective <= 1e-6, equal ``converged``; for
the adaptive body, where the two objectives part beyond the bar on a
problem that either side left unsettled (fixed-point residual above 1e-4),
chip_smoke.py's float64 referee: the port within the bar plus
REFEREE_FACTOR times kmpc_tpu's own distance from the plain version run in
float64.
"""

import numpy as np
import pytest
import torch

from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams
from kmpc_tpu_torch.ops.mpc_cuda import SMEM_PER_BLOCK, block_threads

MV_OBJ_TOL, MV_W_TOL = 1e-6, 5e-5
FEAS_TOL = 1e-5
UNSETTLED_FP = 1e-4
REFEREE_FACTOR = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: one torch thread, as in
    test_torch_port_mv_block.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, "gamma": 5.0, **kw})


def _mv_inputs(B, H, N, seed, shared, scale=0.05):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N) if shared else (B, N, N)) * scale
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4
    # A slightly asymmetric input: the wrappers symmetrise it first.
    sig = sig + 1e-5 * np.triu(np.ones((N, N)), 1)
    return cw, mu, sig.astype(np.float32)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# (H, N, C, adaptive) -> (threads a CTA, column slots a CTA, rows staged,
# floats a CTA), counted by hand: T = 32 ceil(min(N, 512) / 32), Tc = T / C,
# LW = ceil(N / T) Tc; w H ceil4(N), the own p, mu, projection input (and
# adaptive dual input) H LW each, the current weights LW, thresholds H,
# residuals 4, two stagings 2 (T / 32) 2H, rounded up to 4 floats; then
# Sigma column-major [LW][S] in the rest of 58112 floats (232448 bytes):
# every row at the least stride S >= N that is 4 mod 8 where it fits, else
# S rows at the largest such stride that fits.
PLANS = {
    # the global path's Markowitz shape: 1325 -> 1328 floats, 887 strides
    # of 64 fit, 884 is the largest that is 4 mod 8
    (1, 1000, 16, False): (32, 64, 884, 1328 + 884 * 64),
    # 1581 -> 1584; 441 fit, 436
    (1, 1000, 8, False): (64, 128, 436, 1584 + 436 * 128),
    # one slot a thread, every row staged at stride 300: 601 -> 604 floats
    (1, 300, 5, False): (64, 64, 300, 604 + 300 * 64),
    # N=301: w's rows padded to 304; 509 -> 512; stride 308
    (1, 301, 10, True): (32, 32, 301, 512 + 308 * 32),
    # the entry points' shape: 20000 + 4 * 20 * 128 + 128 + 24 + 1280 =
    # 31672; 206 fit, 204
    (20, 1000, 8, True): (64, 128, 204, 31672 + 204 * 128),
    # 20000 + 3 * 20 * 64 + 64 + 24 + 1280 = 25208; 514 fit, 508
    (20, 1000, 16, False): (32, 64, 508, 25208 + 508 * 64),
    # 16500 + 3 * 33 * 64 + 64 + 37 + 2112 = 25049 -> 25052, every row at
    # stride 500
    (33, 500, 8, False): (64, 64, 500, 25052 + 500 * 64),
    # three slots a thread: 1100 + 3 * 96 + 96 + 5 + 64 = 1553 -> 1556;
    # 589 fit, 588
    (1, 1100, 16, False): (32, 96, 588, 1556 + 588 * 96),
}


@pytest.mark.parametrize("key,want", list(PLANS.items()))
def test_mv_cluster_plan_by_hand(key, want):
    H, N, C, adaptive = key
    Tc, LW, rows, floats = want
    assert V.mv_cluster_plan(H, N, C, adaptive) == (C, Tc, LW, rows,
                                                    4 * floats)
    assert 4 * floats <= SMEM_PER_BLOCK


@pytest.mark.parametrize("H,N,C", [
    (1, 1000, 1),     # one CTA: the block layout
    (1, 1000, 3),     # 3 does not divide 16 warps
    (1, 1000, 17),    # past MV_CLUSTER_MAX
    (1, 240, 16),     # 8 warps
    (252, 1000, 16),  # w alone is 252000 floats
    (0, 1000, 16), (1, 0, 1),
])
def test_mv_cluster_plan_refuses(H, N, C):
    assert V.mv_cluster_plan(H, N, C, True) is None


def test_mv_cluster_plan_over_a_grid():
    """Every plan the sizes give: the block kernel's threads split evenly,
    within a block's shared memory, its staged rows every row or a stride
    that is 4 mod 8 with no larger such stride fitting; the adaptive plan
    staging no more; the routed size the measured one for the batch (16
    CTAs at one row past 512 assets for up to 32 problems, 4 at one row up
    to 256 assets, else 2), or the largest size below it that the plan
    takes, else the least; a shape is supported where some size holds its
    adaptive plan."""
    for H in (1, 2, 3, 5, 20, 33, 40, 60, 128):
        for N in (33, 129, 240, 300, 500, 512, 513, 800, 1000, 1100, 2400):
            T = block_threads(N)
            for adaptive in (False, True):
                sizes = V.mv_cluster_sizes(H, N, adaptive)
                for C in sizes:
                    c, Tc, LW, rows, nbytes = V.mv_cluster_plan(
                        H, N, C, adaptive)
                    assert (c, Tc * C) == (C, T) and (T // 32) % C == 0
                    assert LW == -(-N // T) * Tc
                    assert nbytes <= SMEM_PER_BLOCK and 0 <= rows <= N
                    # Every row, or a stride of 4 mod 8 rows (none where
                    # fewer than four fit) that is the largest to fit.
                    assert rows == N or (
                        rows % 8 == (4 if rows else 0)
                        and nbytes + 4 * LW * (8 if rows else 4)
                        > SMEM_PER_BLOCK)
                    if adaptive:
                        fixed = V.mv_cluster_plan(H, N, C, False)
                        assert fixed[3] >= rows
                for B in (1, 32, 33, 132, 133, 1013):
                    routed = V.mv_cluster_ctas(H, N, adaptive, B)
                    if not sizes:
                        assert routed == 0
                        continue
                    if H == 1 and N > 512 and B <= 32:
                        want = 16
                    elif H == 1 and N <= 256:
                        want = 4
                    else:
                        want = 2
                    below = [c for c in sizes if c <= want]
                    assert routed == (below[-1] if below else sizes[0])
            assert V.mv_cluster_supports(H, N) == bool(
                V.mv_cluster_sizes(H, N, True))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

# The mean-variance shapes (H, N) kernel C's layouts refused before the
# global layout (tests/test_torch_port_global.py's REFUSED), and the
# global layout's other shapes a cluster holds.
REFUSED_MV = [(5, 2400), (20, 1000), (33, 500), (60, 500), (252, 1000)]


def test_refused_and_global_shapes_route_to_the_cluster_layout():
    """Every mean-variance shape the port once refused routes, for any
    batch, to the cluster layout's kernel of its body where a cluster
    holds it, else to the global layout's (H=252 N=1000: w alone passes a
    CTA's shared memory); ``allow_short`` stays in the block and global
    layouts."""
    for H, N in REFUSED_MV:
        want = "cluster" if V.mv_cluster_supports(H, N) else "global"
        assert want == ("global" if H == 252 else "cluster")
        for shared in (False, True):
            for B in (1, 32, 132, 1013):
                for p in (MPCParams(), MPCParams(adaptive=True,
                                                 adapt_every=2)):
                    assert V._mv_route(H, N, p, shared, B) == (
                        want, V._MV_KERNELS[(want, p.adaptive)])
                assert V.mv_kernel_layout(H, N, shared, B=B,
                                          allow_short=True) == "global"
    assert V.mv_kernel_layout(1, 1000, allow_short=True) == "block"
    with pytest.raises(ValueError, match="allow_short"):
        V._mv_launch(V.PDHG_MEAN_VARIANCE_CLUSTER, torch.ones(1, 8),
                     torch.ones(1, 1, 8), torch.eye(8),
                     MPCParams(allow_short=True))


def test_the_global_paths_shapes_route_to_the_cluster_kernels():
    """``global_path``'s Markowitz solve (B=1013 dates, H=1, N=1000, a
    covariance per date) and its entry points at H=20 N=1000 (B=32, a
    covariance per date and one shared, both bodies) route to the cluster
    kernels, at the sizes chip_smoke.py launches (2 CTAs; 4 for the
    adaptive body at H=20, whose plan takes no 2); the one-row shapes the
    block layout stages Sigma for stay there."""
    fixed, acc = MPCParams(gamma=1.0), MPCParams(adaptive=True,
                                                 adapt_every=2)
    assert V._mv_route(1, 1000, fixed, False, 1013) == (
        "cluster", V.PDHG_MEAN_VARIANCE_CLUSTER)
    assert V.mv_cluster_ctas(1, 1000, False, 1013) == 2
    assert V.mv_cluster_ctas(1, 1000, False, 32) == 16
    for shared in (False, True):
        for p in (fixed, acc):
            assert V._mv_route(20, 1000, p, shared, 32)[0] == "cluster"
            assert V._mv_route(20, 1000, p, shared, 1013)[0] == "cluster"
    assert V.mv_cluster_ctas(20, 1000, False, 32) == 2
    assert V.mv_cluster_ctas(20, 1000, True, 32) == 4
    assert V.mv_sigma_staged(1, 238)
    assert V.mv_kernel_layout(1, 238, B=1013) == "block"
    assert V.mv_kernel_layout(1, 128, B=1013) == "lanes"


def test_a_cluster_plan_the_kernel_refuses_raises_before_any_launch():
    """A cluster kernel launched privately at a size its plan refuses
    raises ``ValueError`` naming the size, before the card is asked; a
    CUDA solve is refused for CPU tensors."""
    N = 1000
    with pytest.raises(ValueError, match="no plan of 3 CTAs"):
        V._mv_launch(V.PDHG_MEAN_VARIANCE_CLUSTER, torch.ones(1, N),
                     torch.ones(1, 1, N), torch.eye(N), MPCParams(),
                     cluster_ctas=3)
    with pytest.raises(ValueError, match="CUDA"):
        V.pdhg_mean_variance_cuda(torch.ones(2, N), torch.ones(2, 1, N),
                                  torch.ones(2, N, N), MPCParams())


# ---------------------------------------------------------------------------
# The packed wrapper against kmpc_tpu's
# ---------------------------------------------------------------------------

# name: (B, H, N, shared, the batch routing is asked at); 200 iterations.
# One row past the block layout's staging (a covariance per problem), and
# H=40 N=300 (past a block's shared memory and the tile layout's 32 rows:
# the global layout's before this layout), per problem and shared.
ROUTED = {
    "H1N300": (3, 1, 300, False, 1013),
    "H1N520": (2, 1, 520, False, 1013),
    "H40N300": (2, 40, 300, False, 32),
    "H40N300_shared": (2, 40, 300, True, 32),
    "H36N330_shared": (2, 36, 330, True, 32),
}
BODIES = {"fixed": dict(proj_refresh_every=16),
          "adaptive": dict(adaptive=True, adapt_every=2)}


@pytest.mark.parametrize("name,body", [
    (name, body) for name in ROUTED for body in BODIES])
def test_cluster_shape_matches_kmpc_tpu(name, body):
    """At a shape the port's card routes to the cluster layout, the port's
    packed wrapper meets the mean-variance bars against kmpc_tpu's
    (its Pallas kernel in interpret mode where it takes the shape, else
    its XLA solver), the adaptive objective by the float64 referee where
    a side did not settle."""
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    B, H, N, shared, routed_b = ROUTED[name]
    kw = dict(BODIES[body], max_iters=200)
    p = _params(kw)
    assert V.mv_kernel_layout(H, N, shared, p.adaptive, routed_b) == \
        "cluster"
    cw, mu, sig = _mv_inputs(B, H, N, 2101 + H + N, shared)
    w_ref, info_ref = JP.solve_mpc_mean_variance_pallas_packed(
        jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
        _params(kw, JParams), interpret=True)
    w, info = V.solve_mpc_mean_variance_packed(
        torch.as_tensor(cw), torch.as_tensor(mu), torch.as_tensor(sig), p,
        device="cpu")
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    assert set(info) == set(info_ref)
    obj, obj_ref = info["objective"].numpy(), info_ref["objective"]
    fp, fp_ref = (info["fixed_point_residual"].numpy(),
                  info_ref["fixed_point_residual"])
    apart = np.abs(obj - obj_ref) > MV_OBJ_TOL
    astray = apart & (np.maximum(fp, fp_ref) > UNSETTLED_FP) & p.adaptive
    if astray.any():
        sym = torch.as_tensor(sig).double()
        sym = 0.5 * (sym + sym.transpose(-1, -2))
        cw64, mu64 = torch.as_tensor(cw).double(), torch.as_tensor(mu).double()
        w64, fp64 = V.pdhg_mean_variance_plain(cw64, mu64, sym, p)
        obj64 = V._finalize_mv(w64, fp64, mu64, sym, cw64, p)[1][
            "objective"].numpy()
        assert np.all(np.abs(obj - obj64)[astray] <= MV_OBJ_TOL
                      + REFEREE_FACTOR * np.abs(obj_ref - obj64)[astray]), \
            (obj, obj_ref, obj64)
    held = ~astray
    np.testing.assert_allclose(w.numpy()[held], np.asarray(w_ref)[held],
                               atol=MV_W_TOL, rtol=0)
    np.testing.assert_allclose(obj[held], obj_ref[held], atol=MV_OBJ_TOL,
                               rtol=0)
    np.testing.assert_allclose(fp[held], fp_ref[held], atol=MV_W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])
    w64 = w.double().numpy()
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= FEAS_TOL) and w64.min() >= 0


# ---------------------------------------------------------------------------
# On a card: the block kernel's and the global kernel's bits
# ---------------------------------------------------------------------------

# name: (B, H, N, shared, params, the layout whose bits it gives, sizes)
CUDA_CASES = {
    "H1N300_refresh16": (5, 1, 300, False, dict(proj_refresh_every=16),
                         "block", (2, 5)),
    "H1N300_shared_adaptive": (5, 1, 300, True, BODIES["adaptive"], "block",
                               (5, 10)),
    "H1N1000": (3, 1, 1000, False, dict(), "block", (8, 16)),
    "H1N1000_adaptive_over_relax": (3, 1, 1000, False, dict(
        BODIES["adaptive"], over_relax=1.5), "block", (16, 4)),
    "H20N1000": (3, 20, 1000, False, dict(), "global", (16, 8)),
    "H20N1000_shared_adaptive": (3, 20, 1000, True, BODIES["adaptive"],
                                 "global", (16, 8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cluster_layout_gives_the_block_and_global_bits_on_the_card(name):
    """Launched privately at two cluster sizes, the cluster kernel gives
    the bits of the block kernel (one row) or the global kernel (H=20
    N=1000) on the same inputs: weights, fixed-point residuals and the
    adaptive body's steps. Each column's product, each reduce's order and
    every decision are that layout's, the columns split over a cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these cases)")
    B, H, N, shared, kw, other, sizes = CUDA_CASES[name]
    p = _params(dict(kw, max_iters=300))
    cw, mu, sig = (torch.as_tensor(x, device="cuda") for x in
                   _mv_inputs(B, H, N, 2201 + H + N, shared, scale=0.01))
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    ref = V._mv_launch(V._MV_KERNELS[(other, p.adaptive)], cw, mu, sig, p,
                       return_steps=p.adaptive)
    for C in sizes:
        out = V._mv_launch(V._MV_KERNELS[("cluster", p.adaptive)], cw, mu,
                           sig, p, return_steps=p.adaptive, cluster_ctas=C)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(out, ref)]
        assert all(same), f"{name} at {C} CTAs: weights, fp, steps " \
            f"equal: {same}"
