"""The eighth slice of kmpc_tpu_torch against kmpc_tpu: kernel C (the
mean-variance solve) in the tile layout (``csrc/pdhg_mean_variance_tile{,
_adaptive}.cu``): one warp per (problem, horizon row), P problems a CTA, the
product Sigma W taken by the whole CTA with one Sigma a CTA, resident in
shared memory or streamed through a ring of row blocks.

On the CPU: the tile plan (``mv_tile_plan``, counted here by hand;
chip_smoke.py holds it against the value the built library reports), the
choice of the problems a CTA, the routing over (H, N, shared, body), a numpy
model of the kernel's product order against the plain product, and the plain
version against kmpc_tpu's Pallas kernel (interpret mode) at small shared-
Sigma shapes that route to the tile layout. On a card (marked ``cuda``, and
skipped here): the tile kernels against the plain version, twice for the
same bits; JAX is imported only inside the Pallas comparison, so that

    python -m pytest tests/test_torch_port_mv_tile.py -m cuda --noconftest

runs them on a machine without it (the suite's conftest.py imports JAX).

Bars (the repository's mean-variance kernel-vs-XLA bars): weights and the
fixed-point residual <= 5e-5, objective <= 1e-6, equal ``converged``.
"""

import numpy as np
import pytest
import torch

from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams

MV_W_TOL, MV_OBJ_TOL = 5e-5, 1e-6
LIMIT = V.SMEM_PER_BLOCK // 4   # floats of a block's shared memory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: one torch thread, as in
    test_torch_port_mv_block.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,H,N,adaptive,floats,ring", [
    # N CP (W^T) + C KW (G, the dual [, w past 128 assets] [, wbar where
    # H > 1] [, dw and dp adaptive, H > 1]) [+ 2 C 32 adaptive] + ceil4(C),
    # then Sigma: N ceil4(N) resident (CP = ceil4(C)), else 3 Tj ceil4(N)
    # streamed (CP = ceil8(C)).
    (1, 5, 30, False, 30 * 8 + 5 * 3 * 32 + 8 + 30 * 32, 0),
    (1, 5, 30, True, 30 * 8 + 5 * 5 * 32 + 2 * 5 * 32 + 8 + 30 * 32, 0),
    (1, 20, 30, True, 30 * 20 + 20 * 5 * 32 + 2 * 20 * 32 + 20 + 30 * 32,
     0),
    (1, 20, 64, False, 64 * 20 + 20 * 3 * 64 + 20 + 64 * 64, 0),
    (1, 5, 100, False, 100 * 8 + 5 * 3 * 128 + 8 + 100 * 100, 0),
    (3, 2, 20, False, 20 * 8 + 6 * 3 * 32 + 8 + 20 * 20, 0),
    (1, 32, 128, True, 128 * 32 + 32 * 5 * 128 + 2 * 32 * 32 + 32
     + 128 * 128, 0),
    # The widest shapes: Sigma streamed, three stages of 16, 8 or 4 rows.
    (8, 1, 960, False, 960 * 8 + 8 * 3 * 960 + 8 + 3 * 8 * 960, 8),
    (8, 1, 960, True, 960 * 8 + 8 * 3 * 960 + 2 * 8 * 32 + 8
     + 3 * 8 * 960, 8),
    (4, 5, 320, True, 320 * 24 + 20 * 6 * 320 + 2 * 20 * 32 + 20
     + 3 * 8 * 320, 8),
    (4, 5, 320, False, 320 * 24 + 20 * 4 * 320 + 20 + 3 * 16 * 320, 16),
    (4, 1, 1001, False, 1001 * 8 + 4 * 3 * 1024 + 4 + 3 * 8 * 1004, 8),
    (2, 16, 320, False, 320 * 32 + 32 * 4 * 320 + 32 + 3 * 4 * 320, 4),
])
def test_tile_shared_memory_plan(P, H, N, adaptive, floats, ring):
    """``mv_tile_plan`` against the kernel's plan (``mv_tile_layout`` in
    csrc/pdhg_mean_variance_tile.cuh), counted by hand: the bytes and the
    rows of a ring stage (0: Sigma resident)."""
    assert floats <= LIMIT
    assert V.mv_tile_plan(P, H, N, adaptive) == (4 * floats, ring)
    assert V.mv_tile_smem_bytes(P, H, N, adaptive) == 4 * floats


@pytest.mark.parametrize("P,H,N,adaptive", [
    (1, 33, 8, False),      # more than 32 warps
    (2, 17, 8, False),
    (9, 4, 20, True),
    (1, 1, 960, False),     # one warp's tiles of a streamed 960 x 960
    (3, 1, 1001, False),
    (1, 1, 1112, True),
    (1, 20, 800, False),    # the rows' arrays alone past shared memory
    (0, 5, 30, False),
])
def test_tile_plan_refuses_what_it_does_not_take(P, H, N, adaptive):
    assert V.mv_tile_plan(P, H, N, adaptive) is None
    assert V.mv_tile_smem_bytes(P, H, N, adaptive) is None


def _cost(B, P):
    ctas = -(-B // P)
    return -(-ctas // V.TILE_SMS) * P


@pytest.mark.parametrize("B,H,N,shared,adaptive,P", [
    (1028, 1, 960, True, False, 8),     # 129 CTAs, one wave
    (1028, 1, 960, True, True, 8),
    (1028, 5, 320, True, False, 4),     # P H <= 32: 4 of the 6 possible
    (1028, 20, 64, True, True, 1),
    (4096, 5, 100, False, True, 1),     # a per-problem Sigma: one a CTA
    (4096, 20, 30, False, False, 1),
    (1, 1, 20, True, False, 1),
    (1, 1, 960, True, False, 4),        # fewer problems' tiles do not fit
    (301, 2, 20, True, False, 3),       # 101 CTAs, the last ragged
    (264, 1, 64, True, True, 2),
    (16, 1, 960, False, False, 0),      # per problem, no plan: not taken
    (5, 40, 8, True, False, 0),         # H > 32
])
def test_tile_problems_per_cta(B, H, N, shared, adaptive, P):
    """The problems a CTA: P H <= 32, the plan fits, and P is the largest
    value whose waves times P (ceil(ceil(B / P) / 132) P) is least among
    the values that fit; a ragged last CTA where P does not divide B."""
    got = V.mv_tile_problems(B, H, N, shared, adaptive)
    assert got == P
    if P == 0:
        return
    assert P * H <= V.TILE_MAX_WARPS
    assert V.mv_tile_plan(P, H, N, adaptive) is not None
    if shared:
        fits = [q for q in range(1, V.TILE_MAX_WARPS // H + 1)
                if V.mv_tile_plan(q, H, N, adaptive) is not None]
        best = min(_cost(B, q) for q in fits)
        assert _cost(B, P) == best
        assert all(q <= P for q in fits if _cost(B, q) == best)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

GRID_H = [1, 2, 5, 16, 17, 20, 32, 33, 40, 340]
GRID_N = [1, 8, 20, 30, 33, 64, 100, 128, 129, 320, 600, 960, 1112, 1200]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_routing_grid(shared, adaptive):
    """``mv_kernel_layout`` over (H, N) for one problem and for 1028: the
    lane layout at one row of at most 128 assets (the shapes the warp
    layout takes, ``mv_kernel_supports``); else the block layout past
    BLOCK_FIRST_N assets where one problem fits a block, for the fixed body
    unless the batch is past TILE_SMS and shares Sigma or runs
    TILE_STREAM_H rows or more, for the adaptive body at TILE_STREAM_H rows
    or more and at most TILE_SMS problems; else the tile layout
    where its plan takes the batch and holds Sigma resident, or streams it
    at H >= TILE_STREAM_H or, shared, for more than TILE_SMS problems; else
    the block layout where one problem fits a block; else the tile layout
    where its plan takes the batch; else the global layout (None before
    it); the cluster layout at one row with a covariance per problem past
    the block layout's staging, and in place of the global layout where a
    cluster holds the shape.
    ``_mv_route`` names the body's kernel of that layout."""
    p = MPCParams(adaptive=adaptive)
    seen = set()
    for B in (1, 1028):
        for H in GRID_H:
            for N in GRID_N:
                layout = V.mv_kernel_layout(H, N, shared, adaptive, B)
                tile = V.mv_tile_problems(B, H, N, shared, adaptive) > 0
                streams = V.mv_tile_streams(H, N, adaptive)
                block = V.mv_block_smem_bytes(H, N) <= V.SMEM_PER_BLOCK
                few, rows = B <= V.TILE_SMS, H >= V.TILE_STREAM_H
                cluster = V.mv_cluster_supports(H, N)
                if H == 1 and N <= 128:
                    want = "lanes"
                elif (H == 1 and not shared and not V.mv_sigma_staged(H, N)
                      and cluster):
                    want = "cluster"
                elif block and N > V.BLOCK_FIRST_N and (
                        (few and rows) if adaptive
                        else (few or not (shared or rows))):
                    want = "block"
                elif tile and (not streams or H >= V.TILE_STREAM_H
                               or (shared and B > V.TILE_SMS)):
                    want = "tile"
                elif V.mv_block_smem_bytes(H, N) <= V.SMEM_PER_BLOCK:
                    want = "block"
                elif tile:
                    want = "tile"
                else:
                    want = "cluster" if cluster else "global"
                assert layout == want, (B, H, N)
                assert (layout == "lanes") == V.mv_kernel_supports(H, N)
                if H > V.TILE_MAX_WARPS:
                    assert layout in ("block", "global", "cluster"), (H, N)
                seen.add(layout)
                assert V._mv_route(H, N, p, shared, B) == (
                    layout, V._MV_KERNELS[(layout, adaptive)])
    assert {"lanes", "tile", "block", "global"} <= seen
    # The mv_long_wide shapes all take the tile layout.
    for B, H, N, sh in ((1028, 1, 960, True), (1028, 5, 320, True),
                        (4096, 5, 100, False), (4096, 20, 30, False),
                        (1028, 20, 64, True)):
        if sh == shared:
            assert V.mv_kernel_layout(H, N, sh, adaptive, B) == "tile"


@pytest.mark.parametrize("B,H,N,shared,layout", [
    # One row up to 128 assets: lanes (the tile layout 1.13-1.88x slower
    # than the warp layout there, which the lane layout replaced).
    (1028, 1, 128, False, "lanes"), (5, 1, 20, True, "lanes"),
    # Past one row, up to 128 assets, with Sigma resident: tile.
    (1028, 2, 30, False, "tile"), (1, 2, 30, False, "tile"),
    # One row past 128 assets with Sigma resident: block for the fixed
    # body (1.05-1.1x ahead), tile for the adaptive one (1.05-1.12x).
    (5, 1, 129, True, ("block", "tile")),
    (1028, 1, 200, False, ("block", "tile")),
    # A per-problem Sigma streamed: block below three rows (the tile 4-5x
    # slower at one row of 250), tile from three rows past 132 problems,
    # block below them; at one row the cluster layout since it came (at
    # N=240 1.6x the block layout's speed at B=132 and 1013).
    (528, 1, 250, False, "cluster"), (264, 2, 300, False, "block"),
    (264, 3, 300, False, "tile"), (5, 5, 300, False, "block"),
    # A shared Sigma streamed at one row: block up to 132 problems, tile
    # past them; block at H=5 up to 132 problems.
    (1, 1, 960, True, "block"), (132, 1, 960, True, "block"),
    (264, 1, 960, True, "tile"),
    (5, 5, 320, True, "block"),
])
def test_routing_at_the_measured_switches(B, H, N, shared, layout):
    """The layout each side of a switch ``chip_smoke.py``'s ``mv_layouts``
    times (``MV_SWITCH_SHAPES``) is routed to, both bodies (a pair: the
    fixed body's, the adaptive body's)."""
    both = layout if isinstance(layout, tuple) else (layout, layout)
    for adaptive, want in zip((False, True), both):
        assert V.mv_kernel_layout(H, N, shared, adaptive, B) == want


def test_chip_smoke_times_each_side_of_every_switch():
    """``chip_smoke.py``'s ``mv_layouts`` times every switch above, and its
    allowances (``MV_ROUTED_SLOWER``) name only shapes it times, at a body
    it runs there."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    timed = {s[:4]: s[5] for s in C.mv_layout_shapes()}
    switches = [p.args for p in test_routing_at_the_measured_switches
                .pytestmark if p.name == "parametrize"][0][1]
    for B, H, N, shared, _ in switches:
        assert (B, H, N, shared) in timed, (B, H, N, shared)
    for B, H, N, shared, body in C.MV_ROUTED_SLOWER:
        assert body in C.mv_layout_bodies(timed[(B, H, N, shared)])
    # Both sides of each switch are timed: some routed to each layout.
    routed = {V.mv_kernel_layout(H, N, sh, False, B)
              for B, H, N, sh in C.MV_SWITCH_SHAPES}
    assert routed == {"lanes", "tile", "block", "cluster"}


# ---------------------------------------------------------------------------
# The product's order
# ---------------------------------------------------------------------------


def tile_product_model(sig, W, ring):
    """The kernel's G = Sigma W in float32, in its order: G[i, c] summed
    over j = 0..N-1 in order (a stage of ``ring`` rows of Sigma at a time
    where Sigma is streamed, 0: resident), each term Sigma[j, i] W[j, c]
    added as the kernel's fused multiply-add (rounded once, here through
    float64). sig [N, N] symmetric, W [N, C]."""
    N, C = W.shape
    acc = np.zeros((N, C), np.float32)
    step = ring or N
    for j0 in range(0, N, step):
        for j in range(j0, min(N, j0 + step)):
            acc = (acc.astype(np.float64) + sig[j, :, None].astype(np.float64)
                   * W[j][None, :].astype(np.float64)).astype(np.float32)
    return acc


@pytest.mark.parametrize("P,H,N,adaptive", [
    (8, 1, 960, True),      # streamed, four rows a stage
    (4, 5, 320, False),     # streamed, sixteen rows a stage
    (4, 1, 1001, False),    # streamed, N not a multiple of four
    (1, 5, 100, False),     # resident
])
def test_tile_product_order_matches_the_plain_product(P, H, N, adaptive):
    """A numpy model of the kernel's product (Sigma in the plan's row
    blocks, accumulated per (i, c) in j order) equals the plain version's
    product (``grad_g``'s multiply and sum over j) within 1e-6 relative to
    the sum of the magnitudes of the terms, (|Sigma| |W|)[i, c], the scale
    of a float32 sum's rounding; both lie as close to the float64
    product."""
    ring = V.mv_tile_plan(P, H, N, adaptive)[1]
    rng = np.random.default_rng(N + H)
    A = rng.standard_normal((N, N)) * 0.01
    sig = (A @ A.T + np.eye(N) * 1e-4).astype(np.float32)
    W = rng.dirichlet(np.ones(N), size=P * H).T.astype(np.float32)
    model = tile_product_model(sig, W, ring)
    # The plain version's product, as pdhg_mean_variance_plain forms it.
    w = torch.as_tensor(W.T.copy())[None]
    plain = (torch.as_tensor(sig)[None, None] * w[:, :, None, :]).sum(-1)
    plain = plain[0].numpy().T
    exact = sig.astype(np.float64) @ W.astype(np.float64)
    terms = np.abs(sig).astype(np.float64) @ np.abs(W).astype(np.float64)
    for a, b in ((model, plain), (model, exact), (plain, exact)):
        assert np.all(np.abs(a - b) <= 1e-6 * terms)


# ---------------------------------------------------------------------------
# The plain version against kmpc_tpu's Pallas kernel at tile shapes
# ---------------------------------------------------------------------------

# name: (B, H, N, params)
CASES = {
    "H3N12_shared": (4, 3, 12, dict(max_iters=400, proj_refresh_every=16)),
    "H2N40_shared_adaptive_k2": (3, 2, 40, dict(
        max_iters=400, adaptive=True, adapt_every=2)),
}


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, "gamma": 5.0, **kw})


@pytest.mark.parametrize("name", list(CASES))
def test_tile_shapes_match_pallas(name):
    # JAX inside the test: the card's tests below run without it.
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    B, H, N, kw = CASES[name]
    p = _params(kw)
    assert V.mv_kernel_layout(H, N, True, p.adaptive) == "tile"
    cw, mu, sig = _inputs(B, H, N, 801 + H + N, True)
    w_ref, info_ref = JP.solve_mpc_mean_variance_pallas_packed(
        jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
        _params(kw, JParams), interpret=True)
    w, info = V.solve_mpc_mean_variance_packed(
        torch.as_tensor(cw), torch.as_tensor(mu), torch.as_tensor(sig), p,
        device="cpu")
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=MV_W_TOL,
                               rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], atol=MV_OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"].numpy(),
                               info_ref["fixed_point_residual"],
                               atol=MV_W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])


# ---------------------------------------------------------------------------
# On a card: the tile kernels against the plain version
# ---------------------------------------------------------------------------

# name: (B, H, N, shared, problems a CTA or None for the plan's, params)
CUDA_CASES = {
    "H5N30": (9, 5, 30, False, None, dict(max_iters=400)),
    "H20N30_adaptive_k1": (5, 20, 30, False, None, dict(
        max_iters=400, adaptive=True, adapt_every=1)),
    "H2N20_shared_P3_ragged": (7, 2, 20, True, 3, dict(max_iters=400)),
    "H1N960_shared_streamed_adaptive": (5, 1, 960, True, None, dict(
        max_iters=300, adaptive=True, adapt_every=2)),
    "H1N1001_shared_streamed": (5, 1, 1001, True, 4, dict(max_iters=300)),
    "H5N300_streamed": (5, 5, 300, False, None, dict(max_iters=300)),
    "H1N250_streamed_adaptive": (5, 1, 250, False, None, dict(
        max_iters=300, adaptive=True, adapt_every=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_tile_kernel_matches_plain_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these cases)")
    B, H, N, shared, problems, kw = CUDA_CASES[name]
    p = _params(kw)
    cw, mu, sig = (torch.as_tensor(x, device="cuda")
                   for x in _inputs(B, H, N, 901 + N, shared, scale=0.01))
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    kernel = V._MV_KERNELS[("tile", p.adaptive)]
    runs = [V._mv_launch(kernel, cw, mu, sig, p, problems=problems)
            for _ in range(2)]
    plain = V.pdhg_mean_variance_plain(cw, mu, sig, p)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    wk, ik = V._finalize_mv(*runs[0], mu, sig, cw, p)
    wp, ip = V._finalize_mv(*plain, mu, sig, cw, p)
    assert (ik["objective"] - ip["objective"]).abs().max().item() \
        <= MV_OBJ_TOL
    if not p.adaptive:
        assert (wk - wp).abs().max().item() <= MV_W_TOL

