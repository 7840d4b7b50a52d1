"""The seventh slice of kmpc_tpu_torch: the wide-row layout of kernel A
(``csrc/pdhg_log_utility_wide{,_adaptive}.cu``, one CTA per problem, one
warp per horizon row, the row in shared memory), which takes the solves of
one forecast past the row layout's four slots (N > 128): bench.py's
``assets500`` shape and the block path's N=150.

On the CPU the wide kernels' plain version is ``pdhg_log_utility_plain``,
the plain version of every layout, held against the Pallas kernel at N=160
in tests/test_torch_port_large.py. Here: the wide plan against a count by
hand, the routing over a grid of shapes (rows, warp, wide, block, in that
order, for one forecast; scenario shapes as before), a pinned wide layout,
a numpy model of the kernel's two-stage row sum (each lane over its slots
in slot order, then one butterfly) and of its residual sum over the rows,
and, on the card only, the wide kernels against the plain version.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops.mpc import MPCParams

W_TOL, OBJ_TOL = 5e-4, 1e-5
ACCURATE = dict(adaptive=True, adapt_every=2, precond=True)
PIPE = dict(pipeline_reduces=True, proj_refresh_every=16, precond=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: one torch thread keeps them fast when
    other processes share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(kw):
    return MPCParams(**{"sigma_scale": 2.0, **kw})


def _inputs(B, H, N, seed):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01 + 0.0005).astype(np.float32)
    return cw, ys


# ---------------------------------------------------------------------------
# The plan and the routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,N,adaptive,floats", [
    # Five [H][K * 32] arrays, one [K * 32] row of current weights, the
    # rows' ratios and fp; adaptive: dw and dp, [2][H][32] partials.
    (5, 500, False, 5 * 5 * 512 + 512 + 10),
    (5, 500, True, 7 * 5 * 512 + 512 + 10 + 2 * 5 * 32),
    (5, 150, False, 5 * 5 * 160 + 160 + 10),
    (5, 150, True, 7 * 5 * 160 + 160 + 10 + 320),
    (1, 129, True, 7 * 160 + 160 + 2 + 64),
    (32, 129, False, 5 * 32 * 160 + 160 + 64),
    (20, 384, True, 7 * 20 * 384 + 384 + 40 + 1280),
    (1, 2730, False, 5 * 2752 + 2752 + 2),
])
def test_wide_shared_memory_plan(H, N, adaptive, floats):
    """The wrapper's copy of ``wide_plan`` (chip_smoke.py holds it against
    the built kernel's ``kmpc_wide_smem_bytes``) against a count by hand;
    at bench.py's assets500 shape a CTA takes 53 KB fixed and 75 KB
    adaptive, so four and three problems share an SM's 228 KB."""
    assert M.wide_smem_bytes(H, N, adaptive) == 4 * floats
    sm = 233472   # an H100 SM's shared memory; a CTA reserves 1 KB
    assert sm // (M.wide_smem_bytes(5, 500, False) + 1024) == 4
    assert sm // (M.wide_smem_bytes(5, 500, True) + 1024) == 3


@pytest.mark.parametrize("S", [None, 16])
def test_routing_grid(S):
    """Over H 1..40 and N 1..2730: a shape reaches the first of rows, warp,
    wide and block that takes it, the wide layout taking exactly the
    shapes where H <= 32, N > 128 and its adaptive plan (with S scenarios,
    the returns resident or streamed) fits a block's shared memory, and
    passed over for the block layout only where fewer than three of its
    warps share an SM (H a CTA times the CTAs whose adaptive plans fit an
    SM's 228 KB, each reserving 1 KB: the measured boundary); a scenario
    shape the block layout cannot hold goes to the wide layout wherever it
    fits, and every other shape to the cluster layout where a cluster
    holds it, else to the global layout."""
    before = ("rows", "warp", "block", "wide", "cluster", "global")
    reached = dict.fromkeys(M.LAYOUTS + (None,), 0)
    for H in range(1, 41):
        for N in range(1, 2731):
            fits = M.layout_supports("wide", S, H, N)
            assert fits == (H <= 32 and N > 128 and M.wide_smem_bytes(
                H, N, True, S) <= M.SMEM_PER_BLOCK)
            preferred = H * (233472 // (
                M.wide_smem_bytes(H, N, True, S) + 1024)) >= 3
            assert M.wide_preferred(H, N, S) == preferred
            order = M.LAYOUTS if preferred else before
            want = next((lay for lay in order
                         if M.layout_supports(lay, S, H, N)), None)
            got = M.kernel_layout(S, H, N)
            assert got == want, (S, H, N, got, want)
            reached[got] += 1
    assert M.LAYOUTS == ("rows", "warp", "wide", "block", "cluster",
                         "global")
    if S is None:
        assert reached["wide"] > 0 and reached["block"] > 0
        assert M.kernel_layout(S, 5, 500) == M.kernel_layout(S, 5, 150) \
            == M.kernel_layout(S, 1, 1056) == M.kernel_layout(S, 4, 1600) \
            == M.kernel_layout(S, 3, 1600) == "wide"
        # Past the wide plan (33 rows, or more assets than it holds), and
        # where the block layout measured faster: each side of the switch
        # at one row (three CTAs an SM at 2368 assets, two at 2400) and at
        # two rows (two CTAs at 1888, one at 1920).
        assert M.kernel_layout(S, 33, 200) == "block"
        assert M.kernel_layout(S, 20, 385) == "block"
        for H, wide, block in ((1, 2368, 2400), (2, 1888, 1920)):
            assert M.layout_supports("wide", S, H, block)
            assert M.kernel_layout(S, H, wide) == "wide"
            assert M.kernel_layout(S, H, block) == "block"
        assert M.kernel_layout(S, 1, 2730) == M.kernel_layout(S, 2, 2730) \
            == "block"
    else:
        # N=150 and N=500 (S=16) in the wide layout; 33 rows in the block
        # layout.
        assert reached["wide"] > 0 and reached["warp"] == 0
        assert M.kernel_layout(S, 5, 150) == M.kernel_layout(S, 5, 500) \
            == "wide"
        assert M.kernel_layout(S, 33, 60) == "block"


@pytest.mark.parametrize("params,body", [
    (MPCParams(), "fixed"), (_params(PIPE), "pipe"),
    (_params(ACCURATE), "adaptive")])
def test_wide_route_and_pinned_launch(params, body):
    """Every body routes to the wide kernels at N=150 and N=500; the fixed
    and pipelined bodies share one kernel (the pipelined by a flag).
    chip_smoke.py's private launch (``pinned``) takes the wide layout only
    at a shape it takes, and a CPU tensor only through the plain version."""
    import importlib.util
    from pathlib import Path

    kernel = M.PDHG_LOG_UTILITY_WIDE_ADAPTIVE if body == "adaptive" \
        else M.PDHG_LOG_UTILITY_WIDE
    for N in (150, 500):
        assert M._route(None, 5, N, params) == ("wide", body, kernel)
    assert (kernel in M._PIPE_FLAG) == (body != "adaptive")
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    assert C.pinned_kernel("wide", torch.ones(2, 5, 500), params) is kernel
    with pytest.raises(ValueError, match="the wide layout does not"):
        C.pinned_kernel("wide", torch.ones(2, 5, 128), params)
    with pytest.raises(ValueError, match="the wide layout does not"):
        C.pinned_kernel("wide", torch.ones(2, 4, 33, 500), params)
    cw, ys = _inputs(2, 5, 150, seed=7)
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.pinned("wide", torch.as_tensor(cw), torch.exp(torch.as_tensor(ys)),
                 params)


# ---------------------------------------------------------------------------
# The two-stage row sum, modelled in numpy
# ---------------------------------------------------------------------------


def _butterfly(lanes):
    """``__shfl_xor_sync`` butterfly over 32 float32 lane values, offsets
    16, 8, 4, 2, 1: lane j adds lane j ^ o's value; returns every lane's
    result."""
    x = np.asarray(lanes, dtype=np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        x = (x + x[np.arange(32) ^ o]).astype(np.float32)
    return x


def wide_row_sum(values, N):
    """The wide kernel's sum of a row (``wide_port``, a sweep's count and
    sum, the ball's l1): lane l adds its slots k = 0..K-1 (asset k * 32 +
    l, 0 past N) in slot order, in float32, from 0; then one butterfly."""
    K = -(-N // 32)
    x = np.zeros(K * 32, dtype=np.float32)
    x[:N] = values
    acc = np.zeros(32, dtype=np.float32)
    for k in range(K):
        acc = (acc + x[k * 32:(k + 1) * 32]).astype(np.float32)
    return _butterfly(acc)


def rows_kernel_sum(values, N):
    """The row kernel's order (``warp_sum<1>`` after a per-lane loop over
    its K <= 4 register slots, ``port[0] += x[0][k]``), written from its
    [1][K] register array."""
    K = -(-N // 32)
    assert K <= 4
    regs = np.zeros((32, K), dtype=np.float32)
    for i in range(N):
        regs[i % 32, i // 32] = values[i]
    port = np.zeros(32, dtype=np.float32)
    for lane in range(32):
        s = np.float32(0.0)
        for k in range(K):
            s = np.float32(s + regs[lane, k])
        port[lane] = s
    return _butterfly(port)


f32 = st.floats(-2.0, 2.0, width=32, allow_nan=False)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=st.data(), N=st.integers(1, 600))
def test_two_stage_row_sum(data, N):
    """Every lane ends on the same bits (a warp-uniform threshold); at
    K <= 4 the wide kernel's order is the row kernel's, bit for bit; at any
    K it is within float32's rounding of the float64 sum ((K + 5)
    roundings of at most the absolute sum)."""
    values = np.asarray(data.draw(st.lists(f32, min_size=N, max_size=N)),
                        dtype=np.float32)
    got = wide_row_sum(values, N)
    assert len({v.tobytes() for v in got}) == 1
    if N <= 128:
        assert np.array_equal(got.view(np.int32),
                              rows_kernel_sum(values, N).view(np.int32))
    K = -(-N // 32)
    exact = values.astype(np.float64).sum()
    bound = (K + 5) * np.finfo(np.float32).eps \
        * np.abs(values).astype(np.float64).sum()
    assert abs(float(got[0]) - exact) <= bound + 1e-30


def test_residual_sum_over_rows_is_cta_uniform():
    """The adaptive body's residual: each lane sums e^2 over its row's slots
    into its row's partial, every warp adds the rows' partials in row order
    lane by lane, then one butterfly: every lane of every warp ends on the
    same bits, within float32's rounding of the float64 sum."""
    rng = np.random.default_rng(3)
    H, N = 5, 500
    e = (rng.standard_normal((H, N)) * 1e-3).astype(np.float32)
    K = -(-N // 32)
    x = np.zeros((H, K * 32), dtype=np.float32)
    x[:, :N] = e
    part = np.zeros((H, 32), dtype=np.float32)
    for k in range(K):
        sl = x[:, k * 32:(k + 1) * 32]
        part = (part + sl * sl).astype(np.float32)
    warps = []
    for _ in range(H):
        lane = np.zeros(32, dtype=np.float32)
        for u in range(H):
            lane = (lane + part[u]).astype(np.float32)
        warps.append(_butterfly(lane))
    bits = {v.tobytes() for w in warps for v in w}
    assert len(bits) == 1
    exact = (e.astype(np.float64) ** 2).sum()
    assert abs(float(warps[0][0]) - exact) <= 24 * np.finfo(
        np.float32).eps * exact


# ---------------------------------------------------------------------------
# chip_smoke.py's bar on the layouts, with stand-in layouts
# ---------------------------------------------------------------------------


def _chip_smoke():
    """chip_smoke.py as a module: its bars run on any device."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _standin(cw, r, p, seed, fault=0.0):
    """A stand-in layout's outputs (weights, fixed-point residual): the
    plain version with the assets permuted (another float32 realisation of
    the same solver), with ``fault`` of weight moved in every row of every
    problem from its largest holding to its lowest return."""
    perm = torch.randperm(r.shape[-1],
                          generator=torch.Generator().manual_seed(seed))
    w, fp = M.pdhg_log_utility_plain(cw[:, perm], r[..., perm], p)
    w = w[..., torch.argsort(perm)].clone()
    move = torch.full(w.shape[:-1] + (1,), fault)
    w.scatter_add_(-1, w.argmax(-1, keepdim=True), -move)
    w.scatter_add_(-1, r.argmin(-1, keepdim=True), move)
    return w, fp


@pytest.mark.parametrize("N", [160, 1024])
@pytest.mark.parametrize("faulty", [None, "wide", "block"])
def test_layouts_bar_refuses_a_planted_weight_fault(N, faulty):
    """chip_smoke.py's ``hold_layouts`` (the ``layouts`` phase's bar) on
    the adaptive body of two stand-in layouts, ``wide`` routed: held as
    they are; with 1e-2 of weight moved in every row of one layout (about
    ten typical weights at N=1024), refused, whichever layout it is. Below
    SPREAD_N by the share of problems apart from the routed layout's
    weights, past it by each layout's spread against the float64 run."""
    C = _chip_smoke()
    B, H = 16, 2
    p = _params(dict(max_iters=150, **ACCURATE))
    cw, ys = _inputs(B, H, N, seed=N)
    cw, r = torch.as_tensor(cw), torch.exp(torch.as_tensor(ys))
    outs = {lay: _standin(cw, r, p, seed, 1e-2 if lay == faulty else 0.0)
            for seed, lay in enumerate(("wide", "block"), start=1)}
    res = {}
    if faulty is None:
        C.hold_layouts("standin", cw, r, p, outs, "wide", res)
        assert res["share_beyond_w_tol"]["wide"] == 0.0
        assert ("block" in res) == (N >= C.SPREAD_N)
        return
    with pytest.raises(AssertionError,
                       match="part from the routed|from the float64 run"):
        C.hold_layouts("planted", cw, r, p, outs, "wide", res)


# ---------------------------------------------------------------------------
# On the card: the wide kernels against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("N,kw", [
    (150, dict(max_iters=300, proj_refresh_every=16, precond=True)),
    (500, dict(max_iters=301, **PIPE)),
    (160, dict(max_iters=300, max_turnover=0.0, over_relax=1.5)),
])
def test_wide_kernel_matches_its_plain_version(N, kw):
    """B=6 problems of H=5 in the wide layout, the fixed-step bodies: the
    weights, dual and objective against the plain version on the card
    (weights and duals <= 5e-4, objective <= 1e-5), two runs the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wide kernels are CUDA only "
                    "(chip_smoke.py runs the same checks there)")
    p = _params(kw)
    cw, ys = _inputs(6, 5, N, seed=N)
    cw = torch.as_tensor(cw, device="cuda")
    r = torch.exp(torch.as_tensor(ys, device="cuda")).contiguous()
    layout, body, kernel = M._route(None, 5, N, p)
    assert layout == "wide"
    runs = [M.pdhg_log_utility_cuda(cw, r, p, return_dual=True)
            for _ in range(2)]
    plain = M.pdhg_log_utility_plain(cw, r, p, return_dual=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    wk, ik = M._finalize_packed(runs[0][0], r, cw, p, runs[0][1])
    wp, ip = M._finalize_packed(plain[0], r, cw, p, plain[1])
    assert (wk - wp).abs().max().item() <= W_TOL
    assert (runs[0][2] - plain[2]).abs().max().item() <= W_TOL
    assert (ik["objective"] - ip["objective"]).abs().max().item() <= OBJ_TOL
