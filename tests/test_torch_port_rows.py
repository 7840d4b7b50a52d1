"""The sixth slice of kmpc_tpu_torch against kmpc_tpu: the row-per-warp
layout of kernels A and B (``csrc/pdhg_log_utility{,_scenarios}_rows
{,_adaptive}.cu``, one CTA per problem and one warp per horizon row), which
takes the exact scan's B=1 adaptive solve and the long path's H=20 solves.

The JAX reference is the Pallas wrapper in interpret mode on the CPU, as
tests/test_torch_port_large.py runs it; the port runs the kernels' plain
version through its CPU entry point (the row kernels compute the same
function as the warp and block kernels and share their plain version).
Inputs are made with numpy from a seed. Beside the parity cases: the
routing table (which layout each shape takes, and a pinned layout), the row layout's
budgets (registers by the warps of a CTA, shared memory), the C interfaces
against their ctypes bindings, the bitwise fixed point at which the row
kernels stop a projection's sweeps (a hypothesis test in float32 torch),
and, on the card only, the row kernels' bits against the warp kernels'.

Bars (those of tests/test_torch_port_kernels.py): weights and duals
<= 5e-4, objective <= 1e-5 (scenario: 5e-5), status codes equal outside a
10% band around feas_tol.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kmpc_tpu.ops import mpc_pallas as JP
from kmpc_tpu.ops.mpc import MPCParams as JParams
from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams
from kmpc_tpu_torch.ops.mv_ladder import MV_LADDER
from kmpc_tpu_torch.ops.projections import michelot_sweep

W_TOL, OBJ_TOL, SCEN_OBJ_TOL = 5e-4, 1e-5, 5e-5
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


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, **kw})


def _inputs(B, H, N, seed, S=None):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    shape = (B, H, N) if S is None else (B, S, H, N)
    ys = (rng.standard_normal(shape) * 0.01
          + (0.0005 if S is None else 0.0)).astype(np.float32)
    return cw, ys


# ---------------------------------------------------------------------------
# The row layout's shapes against the Pallas kernel
# ---------------------------------------------------------------------------

# name: (B, S, H, N, params): the scan's shape at the accurate
# configuration, the long path's horizon with scenarios and the pipeline
# configuration, the most rows at four slots.
ROWS_CASES = {
    "scan_B1_H5N20_adaptive": (1, None, 5, 20, dict(max_iters=200,
                                                    **ACCURATE)),
    "S4_H20N12_pipe": (2, 4, 20, 12, dict(max_iters=161, **PIPE)),
    "H32N100_cond": (2, None, 32, 100, dict(max_iters=150,
                                            proj_refresh_every=16)),
}


@pytest.mark.parametrize("name", list(ROWS_CASES))
def test_rows_layout_shapes_match_pallas(name):
    B, S, H, N, kw = ROWS_CASES[name]
    assert M.kernel_layout(S, H, N) == "rows"
    cw, ys = _inputs(B, H, N, seed=611 + H + N, S=S)
    solve = (JP.solve_mpc_log_utility_pallas_packed if S is None
             else JP.solve_mpc_log_utility_scenarios_packed)
    w_ref, info_ref = solve(jnp.asarray(cw), jnp.asarray(ys),
                            _params(kw, JParams), tile_b=128, interpret=True,
                            return_dual=True)
    w_ref = np.asarray(w_ref)
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    solve = (M.solve_mpc_log_utility_packed if S is None
             else M.solve_mpc_log_utility_scenarios_packed)
    w, info = solve(_t(cw), _t(ys), _params(kw), device="cpu",
                    return_dual=True)
    np.testing.assert_allclose(w.numpy(), w_ref, atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["dual"].numpy(), info_ref["dual"],
                               atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], rtol=0,
                               atol=OBJ_TOL if S is None else SCEN_OBJ_TOL)
    p = _params(kw)
    near = np.abs(info_ref["fixed_point_residual"] - p.feas_tol) \
        <= 0.1 * p.feas_tol
    assert np.array_equal(info["status_code"].numpy()[~near],
                          info_ref["status_code"][~near])


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,N,layout", [
    # The exact scan's and the comparison's shape, the headline's, one row.
    (None, 5, 20, "rows"), (16, 5, 20, "rows"), (None, 5, 30, "rows"),
    (None, 1, 20, "rows"),
    # The long path (H=20) and bench.py's long shape, past the warp layout.
    (None, 20, 20, "rows"), (16, 20, 20, "rows"), (None, 20, 30, "rows"),
    # The row layout's edges: 32 rows, four slots; past them the block
    # layout (33 rows, 129 assets, N=500).
    (None, 32, 128, "rows"), (None, 33, 20, "block"), (None, 5, 129, "block"),
    (None, 5, 500, "block"),
    # Scenario returns past the registers (S * K > 16) in shared memory; a
    # problem whose returns fit one warp's slice but not the row plan
    # (the warp layout); past a block's shared memory.
    (64, 8, 64, "rows"), (113, 8, 64, "warp"), (120, 8, 33, "block"),
    (None, 40, 2000, None),
])
def test_routing_table(S, H, N, layout):
    assert M.kernel_layout(S, H, N) == layout
    if layout is None:
        with pytest.raises(ValueError, match="eager solver"):
            M._route(S, H, N, MPCParams())
        return
    for params, body in ((MPCParams(), "fixed"),
                         (_params(PIPE), "pipe"),
                         (_params(ACCURATE), "adaptive")):
        assert M._route(S, H, N, params) == (
            layout, body, M._KERNELS[(S is not None, layout, body)])


def test_rows_layout_takes_only_four_slots_and_32_rows():
    """Over a grid: the row layout's budget is ceil(N/32) <= 4, H <= 32 and
    the adaptive plan within a block's shared memory, and every shape it
    takes routes there; the others go to the warp layout where it fits,
    else to the block layout."""
    for S in (None, 1, 16, 64):
        for H in (1, 2, 5, 8, 9, 17, 20, 21, 32, 33):
            for N in (1, 20, 32, 33, 64, 100, 128, 129, 500):
                fits = M.rows_kernel_supports(S, H, N)
                assert fits == (H <= 32 and N <= 128 and M.rows_smem_bytes(
                    S, H, N) <= M.SMEM_PER_BLOCK), (S, H, N)
                want = "rows" if fits else (
                    "warp" if M.layout_supports("warp", S, H, N) else
                    "block" if M.block_kernel_supports(S, H, N) else None)
                assert M.kernel_layout(S, H, N) == want


@pytest.mark.parametrize("layout,ok", [("warp", True), ("block", True),
                                       ("rows", True), ("lanes", False)])
def test_a_pinned_layout_must_take_the_shape(layout, ok):
    """The entry points take no layout: the shape picks it. To compare
    layouts, or to drive the warp layout's kernel A, which no shape routes
    to, chip_smoke.py launches a layout's kernel by the private launch
    (``pinned``); the layout must take the shape, and a layout that does
    not take it raises, as do CPU tensors."""
    C = _chip_smoke()
    cw, ys = _inputs(3, 5, 20, seed=5)
    p = _params(dict(max_iters=20))
    for entry in (M.solve_mpc_log_utility_packed, M.pdhg_log_utility):
        with pytest.raises(TypeError):
            entry(_t(cw), _t(ys), p, layout=layout)
    r = torch.exp(_t(ys))
    if not ok:
        with pytest.raises(ValueError, match="layout must be one of"):
            C.pinned_kernel(layout, r, p)
        return
    assert C.pinned_kernel(layout, r, p) is M._KERNELS[(False, layout,
                                                        "fixed")]
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.pinned(layout, _t(cw), r, p)
    if layout != "block":
        with pytest.raises(ValueError, match=f"the {layout} layout does not"):
            C.pinned_kernel(layout, torch.ones(1, 5, 500), p)


def test_block_budget_takes_no_solver_flags():
    """The block layout's budget is the shape's alone."""
    with pytest.raises(TypeError):
        M.block_kernel_supports(None, 20, 20, True)
    assert M.block_kernel_supports(None, 20, 20)


# ---------------------------------------------------------------------------
# Budgets and interfaces
# ---------------------------------------------------------------------------


def test_rows_register_bound_by_warps_of_a_cta():
    """Each instantiation is compiled for at most 8, 20 or 32 warps: H=5
    keeps 255 registers a thread (the warp kernel's room), H=20 102, H=32
    64; 16 scenario returns a lane fit that room at every bound."""
    assert [M.rows_warp_bound(H) for H in (1, 5, 8, 9, 17, 20, 21, 32)] == [
        8, 8, 8, 20, 20, 20, 32, 32]
    regs = {hb: min(255, 65536 // (32 * hb)) for hb in M.ROWS_WARP_BOUNDS}
    assert regs == {8: 255, 20: 102, 32: 64}
    assert min(regs.values()) >= 4 * M.ROWS_REG_SLOTS
    with pytest.raises(StopIteration):
        M.rows_warp_bound(M.ROWS_MAX_H + 1)


@pytest.mark.parametrize("S,H,N,bytes_", [
    # [H][K * 32] for p and wbar (and four more adaptive), S * H ratios,
    # 2 H bounds and residuals; S * K > 16 adds [H][S padded][K * 32].
    (None, 5, 20, 4 * (6 * 5 * 32 + 5 + 10)),
    (16, 20, 20, 4 * (6 * 20 * 32 + 16 * 20 + 40)),
    (17, 20, 20, 4 * (6 * 20 * 32 + 17 * 20 + 40 + 20 * 32 * 32)),
    (64, 8, 64, 4 * (6 * 8 * 64 + 64 * 8 + 16 + 8 * 64 * 64)),
    (5, 3, 90, 4 * (6 * 3 * 96 + 5 * 3 + 6)),
    (6, 3, 90, 4 * (6 * 3 * 96 + 6 * 3 + 6 + 3 * 96 * 10)),
])
def test_rows_shared_memory_plan(S, H, N, bytes_):
    """The wrapper's copy of ``rows_plan`` (chip_smoke.py holds it against
    the built kernel's ``kmpc_rows_smem_bytes``); the fixed-step bodies
    stage no moves or residual terms."""
    assert M.rows_smem_bytes(S, H, N) == bytes_
    k = -(-N // 32)
    assert M.rows_smem_bytes(S, H, N, adaptive=False) == \
        bytes_ - 4 * 4 * H * 32 * k
    assert M.rows_smem_bytes(S, 32, 128) <= M.SMEM_PER_BLOCK or S


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", M.KERNELS + V.MV_KERNELS + (MV_LADDER,),
                         ids=lambda k: k.name)
def test_c_interface_matches_its_binding(kernel):
    """Each source's extern "C" signature, type by type, against the
    ctypes argument types the wrapper binds it with (ctypes passes a
    pointer bound as an int cut to 32 bits)."""
    from kmpc_tpu_torch._build import CSRC, SOURCES

    src = (CSRC / SOURCES[kernel.name]).read_text()
    m = re.search(r'extern "C" int ' + kernel.symbol + r"\((.*?)\)\s*\{",
                  src, re.S)
    assert m, kernel.name
    params = [re.sub(r"\s+", " ", p).strip() for p in m.group(1).split(",")]
    types = [_CTYPES[p.rsplit(" ", 1)[0]] for p in params]
    assert types == kernel.argtypes


# ---------------------------------------------------------------------------
# The bitwise fixed point of a Michelot sweep
# ---------------------------------------------------------------------------

f32 = st.floats(-1.0, 1.0, width=32, allow_nan=False)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(v=st.lists(f32, min_size=1, max_size=40), pad=st.integers(0, 12),
       ball=st.booleans(), theta0=f32)
def test_a_sweep_that_returns_its_threshold_is_a_fixed_point(v, pad, ball,
                                                             theta0):
    """The row kernels stop a projection's sweeps when one returns the
    threshold it started from, bit for bit. That changes no bit: the same
    threshold gives the same active set, count and sum, so every later
    sweep returns it again. Here in float32 torch for the simplex (radius
    1) and the ball (the magnitudes |v| with a radius below their l1),
    with masked padding, from a warm threshold: the sweeps run until one
    returns its input (Newton's method on a piecewise-linear function ends
    in finitely many), and five more return the same bits; the threshold
    of a budget of three sweeps with the exit equals that of three
    without."""
    x = torch.tensor(v + [-1e30] * pad, dtype=torch.float32)[None]
    if ball:
        x = torch.where(x > -1e29, x.abs(), x)
        rad = torch.tensor(0.5 * float(x.clamp(min=0).sum()) + 1e-3,
                           dtype=torch.float32)
    else:
        rad = torch.tensor(1.0, dtype=torch.float32)
    theta = torch.tensor([[theta0]], dtype=torch.float32)

    def same(a, b):
        return a.view(torch.int32).item() == b.view(torch.int32).item()

    th = theta
    for _ in range(200):
        nxt = michelot_sweep(x, rad, th)
        if same(nxt, th):
            break
        th = nxt
    assert same(nxt, th), "no bitwise fixed point within 200 sweeps"
    for _ in range(5):
        nxt = michelot_sweep(x, rad, nxt)
        assert same(nxt, th)

    full = theta
    for _ in range(3):
        full = michelot_sweep(x, rad, full)
    early = theta
    for _ in range(3):
        before = early
        early = michelot_sweep(x, rad, early)
        if same(early, before):
            break
    assert same(early, full)


# ---------------------------------------------------------------------------
# On the card: the row kernels give the warp kernels' bits
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("S,body", [(None, "fixed"), (None, "pipe"),
                                    (None, "adaptive"), (16, "fixed"),
                                    (16, "adaptive")])
def test_rows_give_the_warp_kernels_bits(S, body):
    """At a shape both layouts take (B=7, H=5, N=20, 300 iterations), the
    row kernel's weights, dual, fixed-point residual and steps equal the
    warp kernel's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the row and warp kernels are "
                    "CUDA only (chip_smoke.py runs the same check there)")
    kw = {"fixed": dict(max_iters=300), "pipe": dict(max_iters=301, **PIPE),
          "adaptive": dict(max_iters=300, **ACCURATE)}[body]
    p = _params(kw)
    cw, ys = _inputs(7, 5, 20, seed=641, S=S)
    cw = torch.as_tensor(cw, device="cuda")
    r = torch.exp(torch.as_tensor(ys, device="cuda")).contiguous()
    outs = [M._launch(M._KERNELS[(S is not None, layout, body)], body, cw, r,
                      p, None, None, True, p.adaptive)
            for layout in ("warp", "rows")]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------------------
# chip_smoke.py's bars for the row layout, on the CPU
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


@pytest.mark.parametrize("H,N,kw,parts", [
    (5, 20, dict(max_iters=10), False),
    (5, 20, dict(max_iters=10, **ACCURATE), False),
    (5, 20, dict(max_iters=10, **PIPE), False),
    (1, 12, dict(max_iters=10, **ACCURATE), True),
    (8, 64, dict(max_iters=10, **ACCURATE), True),
    (5, 20, dict(max_iters=10, ridge=1e-3), True),
    (4, 128, dict(max_iters=10), False),
    # Never parted on the card: the adaptive body at HM=2 and HM=16, a
    # ridge at HM=8 K=2.
    (2, 20, dict(max_iters=10, **ACCURATE), False),
    (12, 20, dict(max_iters=10, **ACCURATE), False),
    (5, 33, dict(max_iters=10, ridge=1e-3), False),
])
def test_rows_bits_may_part_only_where_named(H, N, kw, parts):
    """The row kernel must give the warp kernel's bits except where
    ``rows_bits_part`` names the operation at which nvcc's fusing differs
    by warp-layout instantiation: the adaptive dual prox off HM=8 K=1, the
    fixed step with a ridge; ``check_bits`` refuses any other parting."""
    C = _chip_smoke()
    reason = C.rows_bits_part(H, N, _params(kw))
    assert bool(reason) is parts
    case = {"case": "t", "bits_equal_warp": False,
            "bits_equal_outputs": [False, True, False], "bits_part": reason}
    if parts:
        assert C.check_bits([case]) == {"cases": 1, "equal": 0,
                                        "parted": ["t"]}
    else:
        with pytest.raises(AssertionError, match="bits differ"):
            C.check_bits([case])
    assert C.check_bits([dict(case, bits_equal_warp=True)])["equal"] == 1


def _unsettled_case(kernel_shift, plain_shift, fp_kernel, fp_plain):
    """Two problems run in float64 by the plain version, with the kernel's
    and the plain version's objectives shifted from it and their
    fixed-point residuals as given (the first problem astray)."""
    C = _chip_smoke()
    cw, ys = _inputs(2, 5, 40, seed=13)
    cw, r = _t(cw), torch.exp(_t(ys))
    p = _params(dict(max_iters=60, **ACCURATE))
    out = M.pdhg_log_utility_plain(cw.double(), r.double(), p)
    obj = M._finalize_packed(out[0], r.double(), cw.double(), p,
                             out[1])[1]["objective"].float()
    astray = torch.tensor([True, False])
    res = {}
    C.hold_unsettled("t", cw, r, p, astray,
                     torch.tensor([fp_kernel, 0.0]),
                     torch.tensor([fp_plain, 0.0]),
                     obj + kernel_shift, obj + plain_shift,
                     C.LOG_UNSETTLED_FP, res)
    return res


@pytest.mark.parametrize("kernel_shift,plain_shift,fp_kernel,fp_plain,ok", [
    # Both unsettled, the kernel below the float64 run: held.
    (-1e-3, 0.0, 5e-4, 5e-4, True),
    # The kernel unsettled above the float64 run: refused.
    (1e-3, 0.0, 5e-4, 5e-4, False),
    # The kernel settled but far from the float64 run: refused.
    (-1e-3, 0.0, 1e-6, 5e-4, False),
    # The kernel settled on the float64 run, the plain version unsettled
    # below it: held.
    (0.0, -1e-3, 1e-6, 5e-4, True),
])
def test_block_path_unsettled_problems_are_held_against_float64(
        kernel_shift, plain_shift, fp_kernel, fp_plain, ok):
    """chip_smoke.py's ``hold_unsettled`` (the block path's adaptive
    problems left unsettled and apart): a settled side within the bar of
    the float64 run, an unsettled kernel not above it."""
    if ok:
        res = _unsettled_case(kernel_shift, plain_shift, fp_kernel, fp_plain)
        assert res["unsettled_apart"] == 1
    else:
        with pytest.raises(AssertionError):
            _unsettled_case(kernel_shift, plain_shift, fp_kernel, fp_plain)


@pytest.mark.parametrize("H,N,kw,parts", [
    # Parted on the card: kernel B's adaptive body at HM=8 K=2.
    (8, 64, ACCURATE, True),
    # Never parted: its adaptive body at the paths' HM=8 K=1, a ridge there.
    (5, 20, ACCURATE, False),
    (5, 20, dict(ridge=1e-3), False),
])
def test_rows_bits_may_part_only_at_traced_instantiations(H, N, kw, parts):
    """For kernel B, ``rows_bits_part`` excuses only the (HM, K, body)
    instantiations at which the row and warp kernels parted on the card."""
    S = 16
    C = _chip_smoke()
    reason = C.rows_bits_part(H, N, _params(dict(max_iters=10, **kw)), S)
    assert bool(reason) is parts


def test_check_bits_refuses_more_partings_than_were_traced():
    """Each excused parting counts: more than ROWS_BITS_PARTED of them
    (the count the card showed) fail until someone traces the new ones."""
    C = _chip_smoke()
    parted = {"bits_equal_warp": False, "bits_part": "traced",
              "bits_equal_outputs": [False, True]}
    cases = [dict(parted, case=f"c{i}") for i in range(C.ROWS_BITS_PARTED)]
    assert C.check_bits(cases)["parted"] == [c["case"] for c in cases]
    with pytest.raises(AssertionError, match="more than the"):
        C.check_bits(cases + [dict(parted, case="new")])


def test_the_sweep_exit_is_one_test_that_row_slots_can_turn_off():
    """The row kernels' early exit has one test, ``settled``, and no build
    switch; ``python -m kmpc_tpu_torch.ops.row_slots`` measures what the
    exit saves by building a copy of the sources in which it never holds."""
    from kmpc_tpu_torch._build import CSRC
    from kmpc_tpu_torch.ops import row_slots

    text = (CSRC / "pdhg_log_utility_rows.cuh").read_text()
    assert text.count(row_slots.SETTLED) == 1
    assert text.count("settled(") == 4 and "#ifndef" not in text
