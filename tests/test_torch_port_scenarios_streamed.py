"""The ninth slice of kmpc_tpu_torch against kmpc_tpu: kernel B for any
number of scenarios. The row layout keeps a problem's scenario returns in
registers, resident in the CTA's shared memory, or streamed through each
warp's ring of chunk stages (``csrc/pdhg_log_utility_rows.cuh``); the
wide-row layout takes scenarios past 128 assets, resident or streamed
(``csrc/pdhg_log_utility_{,scenarios_}wide*.cu``). The streamed plan does
not grow with S, so ``python -m kmpc_tpu_torch.run_experiment --scenarios
512`` and ``--horizon 20 --scenarios 128`` have a kernel on the card.

The JAX reference is kmpc_tpu's ``solve_mpc_log_utility_scenarios_packed``,
which takes its XLA solver at every shape here (past its Pallas kernel's
VMEM budget); the port runs its kernels' plain version through its CPU entry
point. Inputs are made with numpy from a seed. Beside the parity cases: the
routing over S, the plans' independence of S, a numpy model of the
transposing butterfly that sums a chunk's portfolio values, and, on the card
only, every storage against the plain version and against the others' bits;
JAX is imported only inside the comparison with kmpc_tpu, so that
``python -m pytest tests/test_torch_port_scenarios_streamed.py -m cuda
--noconftest`` runs the card's cases on a machine without it.

Bars (those of tests/test_torch_port_kernels.py): weights and duals
<= 5e-4, objective <= 5e-5, status codes equal outside a 10% band around
feas_tol.
"""

import numpy as np
import pytest
import torch

from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops.mpc import MPCParams

W_TOL, SCEN_OBJ_TOL = 5e-4, 5e-5
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


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, **kw})


def _inputs(B, S, H, N, seed):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, S, H, N)) * 0.01).astype(np.float32)
    return cw, ys


# ---------------------------------------------------------------------------
# Routing: S no longer decides whether a shape has a kernel
# ---------------------------------------------------------------------------

ROUTING_S = (1, 16, 64, 104, 105, 113, 114, 336, 337, 364, 502, 512, 1024,
             4096)
ROUTING_H = (5, 8, 20, 32, 33)
ROUTING_N = (20, 64, 128, 150, 500)


@pytest.mark.parametrize("S", ROUTING_S)
def test_any_number_of_scenarios_has_a_kernel_where_one_forecast_does(S):
    """At H <= 32 a scenario shape has a kernel wherever one forecast of the
    same H and N has one, but where one forecast itself takes the block
    layout (the wide plan too large: 20 rows of 500 assets) and the block
    layout cannot hold S scenarios' returns, where the cluster layout takes
    it (the global layout where no cluster of at most 8 CTAs holds it), as
    it takes every such shape one forecast takes there; no shape goes to
    the warp layout; at N <= 128 the row layout takes every S."""
    refused = []
    for H in ROUTING_H:
        for N in ROUTING_N:
            one, got = M.kernel_layout(None, H, N), M.kernel_layout(S, H, N)
            assert got != "warp", (S, H, N)
            if H <= 32 and N <= 128:
                assert got == "rows", (S, H, N)
            if H <= 32 and one not in ("cluster", "global") and got in (
                    "cluster", "global"):
                assert one == "block" and not M.layout_supports(
                    "wide", S, H, N) and not M.block_kernel_supports(S, H, N)
                assert got == ("cluster" if M.cluster_kernel_supports(
                    S, H, N) else "global"), (S, H, N)
                refused.append((H, N))
            if one in ("cluster", "global"):
                assert got in ("cluster", "global"), (S, H, N)
    assert refused == ([] if S == 1 else [(20, 500)])


@pytest.mark.parametrize("S,H,N,layout,storage", [
    # The warp path's shape (the warp layout before), the scenario path's
    # two runs, the comparison's S=16 (registers), the block path's S=16
    # past 128 assets (the block layout before), S=64 there.
    (113, 8, 64, "rows", "streamed"), (512, 5, 20, "rows", "streamed"),
    (128, 20, 20, "rows", "resident"), (16, 5, 20, "rows", "registers"),
    (64, 5, 20, "rows", "resident"), (16, 5, 150, "wide", "resident"),
    (64, 5, 150, "wide", "streamed"), (16, 5, 500, "wide", "resident"),
    # Past every earlier layout.
    (4096, 32, 128, "rows", "streamed"), (1024, 8, 500, "wide", "streamed"),
])
def test_scenario_shapes_route_to_a_layout_and_storage(S, H, N, layout,
                                                       storage):
    """The layout and the storage of the returns a CUDA solve takes; the
    kernel of every body is the layout's scenario kernel."""
    assert M.kernel_layout(S, H, N) == layout
    route = M.rows_storage if layout == "rows" else M.wide_storage
    assert route(S, H, N) == storage
    for params, body in ((MPCParams(), "fixed"), (_params(PIPE), "pipe"),
                         (_params(ACCURATE), "adaptive")):
        kernel = M._route(S, H, N, params)[2]
        assert kernel is M._KERNELS[(True, layout, body)]
        assert kernel in M._STORAGE_ARG


@pytest.mark.parametrize("H,N", [(5, 20), (8, 64), (20, 20), (32, 128),
                                 (5, 150), (8, 500), (32, 150)])
def test_the_streamed_plan_does_not_grow_with_S(H, N):
    """Streamed, a problem's plan is the same at every S past the
    registers, and fits a block's shared memory; resident, it grows by S H
    N floats."""
    if N <= 128:
        k = -(-N // 32)
        many = [S for S in ROUTING_S if S * k > M.ROWS_REG_SLOTS]
        plans = {M.rows_smem_bytes(S, H, N, storage="streamed")
                 for S in many}
        grow = [M.rows_smem_bytes(S, H, N, storage="resident") for S in many]
    else:
        many = ROUTING_S
        plans = {M.wide_smem_bytes(H, N, True, S, "streamed") for S in many}
        grow = [M.wide_smem_bytes(H, N, True, S, "resident") for S in many]
    assert len(plans) == 1 and plans.pop() <= M.SMEM_PER_BLOCK
    assert all(b - a == 4 * (t - s) * H * N for a, b, s, t in zip(
        grow, grow[1:], many, many[1:]))


# ---------------------------------------------------------------------------
# The port against kmpc_tpu at shapes the port refused before
# ---------------------------------------------------------------------------

# name: (B, S, H, N): scenarios_path's two runs, the warp path's shape, and
# S=16 at 20 rows of 150 assets (the wide layout, the returns streamed).
SHAPES = {
    "S512_H5N20": (2, 512, 5, 20),
    "S128_H20N20": (2, 128, 20, 20),
    "S113_H8N64": (3, 113, 8, 64),
    "S16_H20N150": (2, 16, 20, 150),
}
BODIES = {"fixed": dict(max_iters=300), "pipe": dict(max_iters=300, **PIPE),
          "adaptive": dict(max_iters=300, **ACCURATE)}
CASES = [(shape, "fixed") for shape in SHAPES] + [
    (shape, body) for shape in ("S512_H5N20", "S113_H8N64")
    for body in ("pipe", "adaptive")]


@pytest.mark.parametrize("shape,body", CASES)
def test_scenarios_packed_matches_kmpc_tpu(shape, body):
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    B, S, H, N = SHAPES[shape]
    kw = BODIES[body]
    # kmpc_tpu's kernel does not take these shapes: it solves them with its
    # XLA solver; the port has a CUDA kernel for each.
    assert JP._default_tile_b_packed(
        H, -(-N // 8) * 8, S=S, extra_blocks=1) is None
    assert M.kernel_layout(S, H, N) is not None
    cw, ys = _inputs(B, S, H, N, seed=913 + S + H + N)
    w_ref, info_ref = JP.solve_mpc_log_utility_scenarios_packed(
        jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams),
        return_dual=True)
    w_ref = np.asarray(w_ref)
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    w, info = M.solve_mpc_log_utility_scenarios_packed(
        torch.as_tensor(cw), torch.as_tensor(ys), _params(kw),
        device="cpu", return_dual=True)
    np.testing.assert_allclose(w.numpy(), w_ref, atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["dual"].numpy(), info_ref["dual"],
                               atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], atol=SCEN_OBJ_TOL,
                               rtol=0)
    assert info["num_scenarios"] == S
    p = _params(kw)
    near = np.abs(info_ref["fixed_point_residual"] - p.feas_tol) \
        <= 0.1 * p.feas_tol
    assert np.array_equal(info["status_code"].numpy()[~near],
                          info_ref["status_code"][~near])


# ---------------------------------------------------------------------------
# The transposing butterfly, modelled in numpy
# ---------------------------------------------------------------------------


def _butterfly(lanes):
    """``__shfl_xor_sync`` butterfly over 32 float32 lane values: lane l
    adds lane l ^ o's value at o = 16, 8, 4, 2, 1."""
    x = np.asarray(lanes, dtype=np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        x = (x + x[np.arange(32) ^ o]).astype(np.float32)
    return x


def _transposing(port, scale):
    """``chunk_factors`` in float32: port [C, 32] each lane's partials;
    returns f [C, 32], scenario s's factor on every lane."""
    C = port.shape[0]
    CP = 1 << max(C - 1, 0).bit_length()
    L = CP.bit_length() - 1
    lanes = np.arange(32)
    v = np.zeros((CP, 32), dtype=np.float32)
    v[:C] = port
    for j in range(L):
        o, h = 16 >> j, CP >> (j + 1)
        hi = (lanes & o) != 0
        nv = v.copy()
        for i in range(h):
            send = np.where(hi, v[i], v[i + h])
            keep = np.where(hi, v[i + h], v[i])
            nv[i] = (keep + send[lanes ^ o]).astype(np.float32)
        v = nv
    x = v[0]
    o = 16 >> L
    while o > 0:
        x = (x + x[lanes ^ o]).astype(np.float32)
        o >>= 1
    mine = (np.float32(scale) / np.maximum(x, np.float32(1e-12))).astype(
        np.float32)
    return np.stack([mine if CP == 1 else np.full(32, mine[s << (5 - L)])
                     for s in range(C)])


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8, 16])
def test_the_transposing_butterfly_gives_the_butterflys_bits(C):
    """Every scenario's factor scale / max(sum, 1e-12) from the transposing
    butterfly equals, bit for bit, the one a butterfly per scenario gives
    every lane (the row and warp kernels' order), for partials of mixed
    sign and magnitude; so the row kernels keep the warp kernels' bits."""
    rng = np.random.default_rng(C)
    for trial in range(20):
        port = (rng.standard_normal((C, 32)) * 10.0 ** rng.integers(
            -3, 3, (C, 32))).astype(np.float32)
        port[:, rng.random(32) < 0.2] = 0.0
        scale = np.float32(rng.choice([-1.0, 0.0123]))
        want = np.stack([
            (scale / np.maximum(_butterfly(port[s]), np.float32(1e-12)))
            .astype(np.float32) for s in range(C)])
        got = _transposing(port, scale)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            (C, trial)


# ---------------------------------------------------------------------------
# On the card: every storage against the plain version and the same bits
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,N", [(40, 5, 20), (16, 5, 20), (16, 5, 150),
                                   (7, 3, 300)])
@pytest.mark.parametrize("body", ["fixed", "pipe", "adaptive"])
def test_storages_give_the_same_bits_and_meet_the_plain_version(S, H, N,
                                                                 body):
    """Every storage of the scenario returns that takes the shape (the row
    layout to 128 assets, the wide-row layout past them) gives the same
    weights, fixed-point residuals, duals and steps bit for bit; the fixed
    and pipelined bodies meet the plain version's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the row and wide-row kernels "
                    "are CUDA only (chip_smoke.py runs the same checks "
                    "there)")
    layout = M.kernel_layout(S, H, N)
    p = _params(dict(BODIES[body], max_iters=200))
    cw, ys = _inputs(3, S, H, N, seed=77 + S)
    cw = torch.as_tensor(cw, device="cuda")
    r = torch.exp(torch.as_tensor(ys, device="cuda")).contiguous()
    kernel = M._KERNELS[(True, layout, body)]
    outs = [M._launch(kernel, body, cw, r, p, None, None, True, p.adaptive,
                      storage=st)
            for st in M.STORAGES if M.storage_supports(layout, st, S, H, N)]
    torch.cuda.synchronize()
    assert len(outs) >= 2
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], out))
    if not p.adaptive:
        plain = M.pdhg_log_utility_plain(cw, r, p, return_dual=True)
        wk = M._finalize_packed(outs[0][0], r, cw, p, outs[0][1])[0]
        wp = M._finalize_packed(plain[0], r, cw, p, plain[1])[0]
        assert (wk - wp).abs().max().item() <= W_TOL
