"""What one problem's solve costs against its horizon rows, per layout.

The warp layout keeps pow2ceil(H) row slots per lane and walks every slot
in every phase, so a lone warp's iteration should cost about as much per
row slot as a whole single-row iteration does; the row layout puts one
warp on each row. This script times the log-utility kernels at B=1, N=20
(the exact scan's shape) over the horizon, adaptive (800 iterations,
``adapt_every=2``, ``precond``: the scan's configuration) and fixed-step
(2000 iterations, ``sigma_scale=2``: the main path's), for each layout that
takes the shape, and prints the time per iteration beside the row slots.
It then reads the adaptive kernels the scan's shape runs as compiled (the
warp layout's at HM=8, K=1; the row layout's at K=1, at most 8 warps): ptxas' registers and spills from the build
log, and from ``cuobjdump -sass`` the count of shuffles, convergence
barriers, branches and division sequences in the whole function and in
each loop (a backward branch and the code it jumps over; the largest is
the iteration loop). Last, what the row kernels' early exit saves: the row
kernels built again from a copy of the sources in which ``settled`` never
holds, against the ones the package ships, at the scan's and the
comparison path's shapes, in turns, with the same bits required of both.

With ``--wide``, the shapes past the row layout's four slots instead: the
block and wide layouts of kernel A at H=5 and N = 150, 256, 500 (5, 8 and
16 warps of the block layout, one asset column a thread; 5 warps of the
wide layout, 5 to 16 slots a lane), at B=1 (one SM alone) and B=4096,
at bench.py's settings: 1000 iterations at refresh 16 with precond, the
same pipelined, 800 adaptive (``adapt_every=2``); each line with the
layout's warps a CTA, its shared memory, ptxas' registers and the CTAs an
SM holds by those three; then both layouts over a grid of H (1 to 32) and
N (129 to 2730) at B=1 and B=1028, 400 iterations fixed and adaptive, for
where the wide layout stops paying; then the SASS counts of the block and
wide kernels' loops (barriers, shuffles, shared-memory loads and stores,
division sequences). ``--boundary H,H:N,N`` times that grid alone, at
the given H and N (the wide layout's switch: H 1..3 at N 1000 to 1600).

With ``--mv``, kernel C at one shared covariance of N=960 assets, H=1
(``mv_long_wide``'s widest shape): the block layout and the tile layout at
200 iterations of bench.py's Markowitz settings (fixed steps at refresh 16,
and adaptive at ``adapt_every=2``) at B = 1, 132, 264, 528 and 1028, each
line with the CTAs, the problems an SM holds at once and the L2 bytes of
Sigma the batch reads (the block layout: B N^2 4 an iteration; the tile
layout: ceil(B / P) N^2 4); a plain read kernel in which 132 (and 264) CTAs
each stream the same N x N float32 matrix from L2 repeatedly, for the rate
this access reaches; and the SASS counts of both layouts' loops (barriers,
global and shared loads, FFMA).

With ``--scen``, kernel B's warp and block layouts (the scenario
shapes before the row layout streamed its returns): the warp kernels'
three bodies (200 iterations of the fixed steps, the pipeline
configuration and the accurate one) at H=8, N=64 and S = 16, 64, 113 at B=1
and B=132, each line with S x pow2ceil(H), the chain one warp walks; the
block kernels at S=16, H=5, N=150 at B=1 and 1028; then a plain streaming
kernel in which each warp reads its own horizon row of a [B][S][H][N]
array (S rows of N floats, H * N apart) by 4-byte cp.async with zero-fill
past N into a three-stage ring of shared memory, 16 / ceil(N/32)
scenarios a stage, pass after pass: at B=132 S=113 H=8 N=64 (30.5 MB,
inside L2) with 132 and 264 CTAs, and at two arrays of about 210 MB (past
L2): B=1028 S=512 H=5 N=20 and B=900 S=113 H=8 N=64; each line with the
rate it reached.

With ``--digest``, a SHA-256 of the one-forecast wide-row kernels'
outputs (weights, fixed-point residuals, duals, the adaptive body's steps)
at the block path's N=150 (B=1028, H=5: fixed, pipelined, adaptive) and at
bench.py's assets500 (B=4096, H=5, N=500, 1000 pipelined iterations), on
inputs made with numpy from fixed seeds; it uses only the launch the
package has had since the wide layout came, so the same script run
against an earlier checkout (``PYTHONPATH``) gives that tree's digest.
``--busy SECONDS`` adds: the digests with every block of the caching
allocator filled with NaN first (an output or a read past an input that
the kernel leaves unwritten would change them), then again and again for
SECONDS beside two processes that run the float64 polished path
(``mpc_polish.solve_mpc_log_utility_batch_polished``, parity_cache/'s
first 32 instances of a family each) on the same card; a round whose
digest differs reports its distance from the first round's outputs and
from the plain version's.

With ``--plain-replay``, the plain versions (kernels A, B and C, float32
and float64, each body) at the comparison path's shape (B=1028, H=5,
N=20; S=16; C at H=1) run eagerly and replayed as CUDA graphs
(``mpc_cuda.plain_replayed``): the same bits required, with both times.

With ``--global``, the global layout at the global path's shape (B=1013
problems of H=20 and N=1000, the path's fixed steps, 400 iterations):
kernel A, kernel B at S=16 and kernel C with a shared covariance, each with
a persistent grid of one and of two CTAs an SM (as far as the SM holds
them), timed in turns (1, 2, 2, 1); each line with the CTAs an SM holds,
the workspace's bytes at each grid and, for B, the bytes of returns read
an iteration; then kernels A and B in the cluster layout at the same shape
and steps, timed in turns with the global kernel (global, cluster, cluster,
global), B in each of ``CLUSTER_RINGS``' rings, with the clusters the card
runs at once; kernel B's two storages in the cluster layout at two shapes
both take (B=1013, S=16: H=20 N=500, where streaming takes half the CTAs,
and H=33 N=128, where both take two); and kernel A in the cluster layout beside
the block layout at H=60 N=64 (B=1013), a shape the block layout holds and
routing keeps there.

With ``--mv-switch``, kernel C's block and tile layouts, both bodies (200
iterations), at ``chip_smoke.py``'s switch shapes where the two run close,
with a SHA-256 of the block kernel's outputs (weights and fixed-point
residuals), then the block kernels' registers, spills and SASS opcode
counts (whole function and each loop); run as ``PYTHONPATH=<an earlier checkout> python
kmpc_tpu_torch/ops/row_slots.py --mv-switch`` it times and reads that
checkout's kernels by the same launches.

With ``--mv-cluster``, kernel C's cluster layout: its bits against the
block or global kernel of the same body at every cluster size its plan
takes (``MV_CLUSTER_BITS``), then its time an iteration at 2, 4, 8 and 16
CTAs beside the block, tile and global layouts (both bodies, in turns) at
one row past the block layout's staging and at the global layout's shapes
(``MV_CLUSTER_SHAPES``), with the clusters the card runs at once, the rows
of Sigma staged and the rate the rest is read at; the measurements that
set ``mv_cuda``'s cluster routing and sizes. With ``--mv-cluster-cuts``,
copies of its fixed-step kernel with one part cut out at a time (the rows
of Sigma read from global memory, the staged rows, the whole product, the
remote writes of w), timed at the global path's Markowitz shape with three
Michelot sweeps an iteration and with none: where an iteration goes.

    python -m kmpc_tpu_torch.ops.row_slots [--layouts warp,rows] [--wide]
        [--boundary 1,2,3:1024,1056] [--mv] [--scen]
        [--digest [--busy SECONDS]] [--plain-replay] [--global]
        [--mv-switch] [--mv-cluster] [--mv-cluster-cuts]

One JSON line per measurement; needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from kmpc_tpu_torch._build import (
    BUILD_DIR, CSRC, NVCC_FLAGS, SOURCES, build_log, find_nvcc, library_path,
)
from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops.mpc import MPCParams

HORIZONS = (1, 2, 4, 5, 8)
N = 20
BODIES = {
    "adaptive": MPCParams(sigma_scale=2.0, max_iters=800, adaptive=True,
                          adapt_every=2, precond=True),
    "fixed": MPCParams(sigma_scale=2.0, max_iters=2000),
}
# The adaptive kernels the scan's shape runs: the warp layout's at HM=8,
# K=1 and the row layout's at K=1 with at most 8 warps (one forecast).
SASS = (("pdhg_log_utility_adaptive",
         r"pdhg_log_utility_kernelILi8ELi1ELb0ELb1ELb0E"),
        ("pdhg_log_utility_rows_adaptive",
         r"pdhg_log_utility_rows_kernelILi1ELi8ELb0ELb1ELb1ELb0E"))
OPCODES = {
    "SHFL": r"\bSHFL\.",
    "BSSY": r"\bBSSY\b",
    "BSYNC": r"\bBSYNC\b",
    "WARPSYNC": r"\bWARPSYNC\b",
    "BRA": r"\bBRA\b",
    "BAR": r"\bBAR\.",
    "LDS": r"\bLDS\b",
    "STS": r"\bSTS\b",
    "MUFU.RCP": r"\bMUFU\.RCP\b",
    "LDG": r"\bLDG\.",
    "FFMA": r"\bFFMA\b",
    "FCHK": r"\bFCHK\b",
    "CALL": r"\bCALL\.",
}


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_layouts(layouts):
    """One line per (body, H, layout): ms and us per iteration at B=1."""
    rng = np.random.default_rng(508)
    for body, p in BODIES.items():
        for H in HORIZONS:
            cw = torch.as_tensor(rng.dirichlet(np.ones(N))[None]
                                 .astype(np.float32), device="cuda")
            ys = rng.standard_normal((1, H, N)) * 0.01 + 0.0005
            r = torch.exp(torch.as_tensor(ys.astype(np.float32),
                                          device="cuda")).contiguous()
            for layout in layouts:
                kernel = M._KERNELS.get((False, layout, body))
                if kernel is None or not M.layout_supports(layout, None, H, N):
                    continue
                ms = cuda_ms(lambda: M._launch(kernel, body, cw, r, p, None,
                                               None, False, False))
                print(json.dumps({
                    "phase": "row_slots", "layout": layout, "body": body,
                    "kernel": kernel.name, "B": 1, "H": H, "N": N,
                    "row_slots": 1 << max(H - 1, 0).bit_length()
                    if layout == "warp" else 1,
                    "iters": p.max_iters, "ms": ms,
                    "us_per_iter": 1e3 * ms / p.max_iters}), flush=True)


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy triton carries."""
    beside = Path(find_nvcc()).parent / "cuobjdump"
    if beside.exists():
        return str(beside)
    found = shutil.which("cuobjdump")
    if found:
        return found
    import triton

    return str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
               / "cuobjdump")


def _counts(lines):
    return {k: sum(1 for ln in lines if re.search(rx, ln))
            for k, rx in OPCODES.items()} | {"instructions": len(lines)}


def sass_report(kernel_name: str, function: str) -> dict:
    """ptxas' line for ``function`` and the opcode counts of its SASS, over
    the whole function and over each loop (largest first)."""
    lib = library_path(kernel_name)
    dump = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    body, name = None, None
    for chunk in dump.split("Function : ")[1:]:
        head = chunk.splitlines()[0].strip()
        if re.search(function, head):
            body, name = chunk, head
            break
    assert body is not None, f"{function} not in {lib.name}"
    instr = []
    for ln in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            instr.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, text in instr:
        m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", text)
        if m and m.group(1) and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            loops.append((addr - lo, lo, addr))
    loops.sort(reverse=True)
    ptxas = [ln.strip() for ln in build_log(kernel_name).splitlines()]
    at = next((i for i, ln in enumerate(ptxas)
               if "Compiling entry function" in ln
               and re.search(function, ln)), None)
    return {
        "phase": "sass", "kernel": kernel_name, "function": name,
        "ptxas": ptxas[at:at + 4] if at is not None else None,
        "whole": _counts([t for _, t in instr]),
        "loops": [dict(first=hex(lo), last=hex(hi), **_counts(
            [t for a, t in instr if lo <= a <= hi])) for _, lo, hi in loops],
    }


SETTLED = "  return bits(th) == before;\n"
# The lane layout's test of the same exit (``lanes_settled``).
LANES_SETTLED = "  return __float_as_uint(th) == __float_as_uint(before);\n"


def without_sweep_exit(kernel, header="pdhg_log_utility_rows.cuh",
                       settled=SETTLED):
    """The function of ``kernel`` (a row kernel, or with ``header`` and
    ``settled`` another whose header has that exit test) built from a copy
    of the sources (in the build directory) whose exit test returns false,
    so that every projection runs its full budget of sweeps, bound as the
    package binds it."""
    import ctypes

    out = library_path(kernel.name).with_name(
        library_path(kernel.name).stem + "_no_exit.so")
    if not out.exists():
        src = BUILD_DIR / f"no_exit_src_{kernel.name}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        header = src / header
        text = header.read_text()
        assert text.count(settled) == 1, "the exit test not found"
        header.write_text(text.replace(settled, "  return false;\n"))
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                        str(src / SOURCES[kernel.name])],
                       check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(out)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    return fn


def time_sweep_exit():
    """One line per (S, B, body): the row kernel with and without the
    early exit, timed in two rounds of 5 in turns; the outputs must agree
    bit for bit (the exit changes no bit)."""
    rng = np.random.default_rng(6)
    for S, B in ((None, 1), (None, 1028), (16, 1028)):
        cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                             .astype(np.float32), device="cuda")
        shape = (B, 5, N) if S is None else (B, S, 5, N)
        ys = rng.standard_normal(shape) * 0.01 + 0.0005
        r = torch.exp(torch.as_tensor(ys.astype(np.float32),
                                      device="cuda")).contiguous()
        for body, p in BODIES.items():
            kernel = M._KERNELS[(S is not None, "rows", body)]
            fns = {"exit": kernel.function(),
                   "no_exit": without_sweep_exit(kernel)}

            def run(fn):
                kernel._fn = fn    # the shipped kernel's launch, this build
                try:
                    return M._launch(kernel, body, cw, r, p, None, None,
                                     True, p.adaptive)
                finally:
                    kernel._fn = fns["exit"]

            outs = [run(fn) for fn in fns.values()]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*outs)), (S, B, body)
            ms = {name: [] for name in fns}
            for _ in range(2):
                for name, fn in fns.items():
                    ms[name].append(cuda_ms(lambda: run(fn)))
            print(json.dumps({
                "phase": "sweep_exit", "S": S, "B": B, "H": 5, "N": N,
                "body": body, "iters": p.max_iters, "ms": ms,
                "no_exit_over_exit": float(np.median(ms["no_exit"])
                                           / np.median(ms["exit"])),
                "same_bits": True}), flush=True)


# --wide: kernel A past the row layout's four slots, at bench.py's
# settings (chip_smoke.py's block_path); the kernels' functions for SASS.
WIDE_H = 5
WIDE_NS = (150, 256, 500)
WIDE_BATCHES = (1, 4096)
WIDE_BODIES = {
    "fixed": MPCParams(sigma_scale=2.0, max_iters=1000,
                       proj_refresh_every=16, precond=True),
    "pipe": MPCParams(sigma_scale=2.0, max_iters=1000, proj_refresh_every=16,
                      precond=True, pipeline_reduces=True),
    "adaptive": MPCParams(sigma_scale=2.0, max_iters=800, adaptive=True,
                          adapt_every=2, precond=True),
}
WIDE_SASS = (("pdhg_log_utility_block",
              r"pdhg_log_utility_block_kernelILb0ELb0E"),
             ("pdhg_log_utility_block_adaptive",
              r"pdhg_log_utility_block_kernelILb0ELb1E"),
             ("pdhg_log_utility_wide",
              r"pdhg_log_utility_wide_kernelILi8ELb0ELb0E"),
             ("pdhg_log_utility_wide_adaptive",
              r"pdhg_log_utility_wide_kernelILi8ELb1ELb0E"))
# Where the wide layout stops paying: both layouts over H and N at B=1 and
# B=1028, 400 iterations of the fixed-step body and of the adaptive one.
BOUNDARY_H = (1, 2, 3, 4, 5, 10, 20, 32)
BOUNDARY_N = (129, 192, 256, 384, 500, 1000, 1024, 1056, 1600, 2730)
BOUNDARY_B = (1, 1028)
BOUNDARY_BODIES = {
    "fixed": MPCParams(sigma_scale=2.0, max_iters=400,
                       proj_refresh_every=16, precond=True),
    "adaptive": MPCParams(sigma_scale=2.0, max_iters=400, adaptive=True,
                          adapt_every=2, precond=True),
}
SM_SMEM = 233472      # shared memory of one SM, bytes (a CTA reserves 1 KB)
SM_REGS = 65536
SM_THREADS = 2048


def _registers(kernel_name: str, function: str):
    """ptxas' registers a thread for ``function`` in ``kernel_name``'s build
    log, or None."""
    lines = build_log(kernel_name).splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and re.search(function, ln):
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    return int(m.group(1))
    return None


def resident_ctas(threads: int, smem: int, regs: int) -> int:
    """CTAs of one kernel an SM holds at once, by its threads, shared
    memory and registers (allotted per warp in units of 256)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(SM_THREADS // threads, SM_SMEM // (smem + 1024),
               SM_REGS // (per_warp * warps), 32)


def time_wide(layouts):
    """One line per (body, N, B, layout): ms, us per iteration, and at
    B=4096 the us per iteration of one resident problem (ms over the
    iterations and the waves the card runs the batch in)."""
    rng = np.random.default_rng(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N in WIDE_NS:
        for B in WIDE_BATCHES:
            cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                                 .astype(np.float32), device="cuda")
            ys = rng.standard_normal((B, WIDE_H, N)) * 0.01 + 0.0005
            r = torch.exp(torch.as_tensor(ys.astype(np.float32),
                                          device="cuda")).contiguous()
            for body, p in WIDE_BODIES.items():
                for layout in layouts:
                    kernel = M._KERNELS.get((False, layout, body))
                    if kernel is None or not M.layout_supports(
                            layout, None, WIDE_H, N):
                        continue
                    ms = cuda_ms(lambda: M._launch(kernel, body, cw, r, p,
                                                   None, None, False, False))
                    fn = dict(WIDE_SASS)[kernel.name]
                    if layout == "block":
                        threads = M.block_threads(N)
                        smem = M.block_smem_bytes(None, WIDE_H, N)
                    else:
                        threads = 32 * WIDE_H
                        smem = M.wide_smem_bytes(WIDE_H, N, p.adaptive)
                    regs = _registers(kernel.name, fn)
                    line = {
                        "phase": "wide", "layout": layout, "body": body,
                        "kernel": kernel.name, "B": B, "H": WIDE_H, "N": N,
                        "warps": threads // 32, "smem_bytes": smem,
                        "registers": regs, "iters": p.max_iters, "ms": ms,
                        "us_per_iter": 1e3 * ms / p.max_iters}
                    if regs is not None:
                        per_sm = resident_ctas(threads, smem, regs)
                        waves = -(-B // (per_sm * sms))
                        line.update(ctas_per_sm=per_sm, waves=waves,
                                    us_per_iter_per_wave=1e3 * ms
                                    / p.max_iters / waves)
                    print(json.dumps(line), flush=True)


def wide_boundary(horizons=BOUNDARY_H, assets=BOUNDARY_N):
    """One line per (H, N, B, body) that both the wide and the block
    layout take: each layout's median ms (two rounds of 5, in turns) and
    block over wide."""
    rng = np.random.default_rng(9)
    for H in horizons:
        for N in assets:
            if not (M.layout_supports("wide", None, H, N)
                    and M.layout_supports("block", None, H, N)):
                continue
            for B in BOUNDARY_B:
                cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                                     .astype(np.float32), device="cuda")
                ys = rng.standard_normal((B, H, N)) * 0.01 + 0.0005
                r = torch.exp(torch.as_tensor(ys.astype(np.float32),
                                              device="cuda")).contiguous()
                for body, p in BOUNDARY_BODIES.items():
                    ms = {"wide": [], "block": []}
                    for _ in range(2):
                        for lay in ms:
                            kernel = M._KERNELS[(False, lay, body)]
                            ms[lay].append(cuda_ms(lambda: M._launch(
                                kernel, body, cw, r, p, None, None, False,
                                False)))
                    med = {lay: float(np.median(t)) for lay, t in ms.items()}
                    print(json.dumps({
                        "phase": "wide_boundary", "H": H, "N": N, "B": B,
                        "body": body, "iters": p.max_iters, "ms": ms,
                        "block_over_wide": med["block"] / med["wide"]}),
                        flush=True)


# --mv: kernel C at one shared Sigma of 960 assets, one row.
MV_N = 960
MV_BATCHES = (1, 132, 264, 528, 1028)
MV_SASS = (("pdhg_mean_variance_block",
            r"pdhg_mean_variance_block_kernelILb0E"),
           ("pdhg_mean_variance_block_adaptive",
            r"pdhg_mean_variance_block_kernelILb1E"),
           ("pdhg_mean_variance_tile",
            r"pdhg_mean_variance_tile_kernelILi0ELi8ELb0E"),
           ("pdhg_mean_variance_tile_adaptive",
            r"pdhg_mean_variance_tile_kernelILi0ELi8ELb1E"))
L2_READ_SRC = r"""
// CTAs each read the same n floats (16-byte loads) `passes` times and
// write one sum, so that the loads stay.
extern "C" __global__ void l2_read(const float4* x, long long n4,
                                   int passes, float* out) {
  float acc = 0.f;
  for (int r = 0; r < passes; ++r)
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = x[i];
      acc += v.x + v.y + v.z + v.w;
    }
  if (acc == 1234.5f) out[blockIdx.x] = acc;
}
extern "C" int launch_l2_read(const void* x, long long n4, int passes,
                              void* out, int ctas, int threads) {
  l2_read<<<ctas, threads>>>(static_cast<const float4*>(x), n4, passes,
                             static_cast<float*>(out));
  return (int)cudaGetLastError();
}
"""


def _l2_read_fn():
    """The plain read kernel, built from L2_READ_SRC into the build
    directory."""
    import ctypes

    out = BUILD_DIR / "libl2_read.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / "l2_read.cu"
        src.write_text(L2_READ_SRC)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).launch_l2_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def time_mv(iters=200):
    """One line per (layout, body, B): kernel C's block and tile layouts
    at a shared Sigma of MV_N assets, H=1; then the L2 read rate of the
    plain read kernel; then the loops' SASS counts."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    rng = np.random.default_rng(960)
    N, H = MV_N, 1
    A = rng.standard_normal((N, N)) * 0.01
    sig = torch.as_tensor((A @ A.T + np.eye(N) * 1e-4).astype(np.float32),
                          device="cuda").contiguous()
    bodies = {
        "fixed": MPCParams(max_iters=iters, sigma_scale=2.0, gamma=5.0,
                           proj_refresh_every=16),
        "adaptive": MPCParams(max_iters=iters, sigma_scale=2.0, gamma=5.0,
                              adaptive=True, adapt_every=2)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sigma_bytes = 4 * N * N
    for B in MV_BATCHES:
        cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                             .astype(np.float32), device="cuda")
        mu = torch.as_tensor((rng.standard_normal((B, H, N)) * 0.01)
                             .astype(np.float32), device="cuda")
        for body, p in bodies.items():
            for layout in ("block", "tile"):
                kernel = V._MV_KERNELS[(layout, p.adaptive)]
                ms = cuda_ms(lambda: V._mv_launch(kernel, cw, mu, sig, p))
                if layout == "block":
                    P, threads = 1, M.block_threads(N)
                    smem = V.mv_block_smem_bytes(H, N)
                    fn = MV_SASS[int(p.adaptive)][1]
                else:
                    P = V.mv_tile_problems(B, H, N, True, p.adaptive)
                    threads = 32 * P * H
                    smem = V.mv_tile_smem_bytes(P, H, N, p.adaptive)
                    fn = MV_SASS[2 + int(p.adaptive)][1]
                ctas = -(-B // P)
                regs = _registers(kernel.name, fn)
                per_sm = (resident_ctas(threads, smem, regs)
                          if regs is not None else None)
                l2 = ctas * sigma_bytes * iters
                print(json.dumps({
                    "phase": "mv", "layout": layout, "body": body,
                    "kernel": kernel.name, "B": B, "H": H, "N": N,
                    "problems_per_cta": P, "ctas": ctas,
                    "threads": threads, "smem_bytes": smem,
                    "registers": regs, "ctas_per_sm": per_sm,
                    "problems_per_wave": None if per_sm is None
                    else per_sm * sms * P,
                    "iters": iters, "ms": ms,
                    "us_per_iter": 1e3 * ms / iters,
                    "l2_sigma_bytes": l2,
                    "l2_sigma_tb_per_s": l2 / (ms * 1e-3) / 1e12}),
                    flush=True)
    fn = _l2_read_fn()
    out = torch.zeros(2 * sms, device="cuda")
    passes = 20
    for ctas in (sms, 2 * sms):
        def run():
            err = fn(sig.data_ptr(), N * N // 4, passes, out.data_ptr(),
                     ctas, 512)
            assert err == 0, err

        ms = cuda_ms(run)
        read = ctas * sigma_bytes * passes
        print(json.dumps({
            "phase": "l2_read", "ctas": ctas, "threads": 512,
            "matrix_bytes": sigma_bytes, "passes": passes, "ms": ms,
            "tb_per_s": read / (ms * 1e-3) / 1e12}), flush=True)
    for kernel, function in MV_SASS:
        print(json.dumps(sass_report(kernel, function)), flush=True)


# --h1: kernel C at one horizon row, at the shapes its paths and bench.py
# give it: (label, B, N, settings). "path": the Markowitz path's settings
# (2000 fixed iterations at gamma 1; the accurate configuration, 800
# adaptive at adapt_every 2), at the comparison's B=1028 and the exact
# scan's B=1; "bench": bench.py's Markowitz settings (1000 iterations at
# refresh 16, sigma_scale 2, gamma 5; 1000 adaptive at adapt_every 2), at
# the ladder's default B=4096 and bench.py's ``--mode markowitz`` B=65536.
H1_SHAPES = (("path", 1028, 20, "path"), ("scan", 1, 20, "path"),
             ("ladder", 4096, 30, "bench"), ("markowitz", 65536, 30, "bench"))
# The ladder at the same four shapes: (B, N, iterations).
H1_LADDER = ((1028, 20, 2000), (1, 20, 800), (4096, 30, 1000),
             (65536, 30, 1000))


def h1_bodies(which):
    """{body: MPCParams} of an ``H1_SHAPES`` settings name."""
    if which == "path":
        return {"fixed": MPCParams(max_iters=2000, gamma=1.0, horizon=1),
                "adaptive": MPCParams(max_iters=800, gamma=1.0, horizon=1,
                                      adaptive=True, adapt_every=2,
                                      precond=True)}
    common = dict(max_iters=1000, sigma_scale=2.0, gamma=5.0)
    return {"fixed": MPCParams(proj_refresh_every=16, **common),
            "adaptive": MPCParams(adaptive=True, adapt_every=2, **common)}


def h1_inputs(B, N, seed):
    """Current weights [B, N], forecasts [B, 1, N] and per-problem
    covariances A A' + 1e-4 I [B, N, N] (A ~ 0.01 N(0, 1)), made on the card
    from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cw = torch.rand((B, N), generator=g, device="cuda") + 0.05
    cw = cw / cw.sum(-1, keepdim=True)
    mu = torch.randn((B, 1, N), generator=g, device="cuda") * 0.01
    A = torch.randn((B, N, N), generator=g, device="cuda") * 0.01
    sig = A @ A.transpose(-1, -2) + 1e-4 * torch.eye(N, device="cuda")
    return cw, mu, (0.5 * (sig + sig.transpose(-1, -2))).contiguous()


def h1_kernels(p):
    """{name: launch(cw, mu, sig)} of kernel C's H=1 layouts for the body
    of ``p``: the warp layout, and the lane layout in each of its
    sweeps."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    out = {"warp": lambda cw, mu, sig: V._mv_launch(
        V._MV_KERNELS[("warp", p.adaptive)], cw, mu, sig, p)}
    for sweep in V.LANES_SWEEPS:
        out[f"lanes:{sweep}"] = (
            lambda cw, mu, sig, s=sweep: V._mv_launch(
                V._MV_KERNELS[("lanes", p.adaptive)], cw, mu, sig, p,
                sweep=s))
    return out


def time_h1(reps=5):
    """One line per (shape, body, layout): kernel C at H=1 in the warp
    layout and the lane layout's two sweeps, at ``H1_SHAPES``, in turns
    (A, B, C, C, B, A); then the routed lane kernel with and without its
    sweeps' early exit, and its adaptive body balancing every second
    iteration, never, and as the fixed-step body; then the ladder's rungs
    at ``H1_LADDER``; then the SASS counts of the loops."""
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops import mv_ladder as D

    for i, (label, B, N, which) in enumerate(H1_SHAPES):
        cw, mu, sig = h1_inputs(B, N, 1100 + i)
        for body, p in h1_bodies(which).items():
            runs = h1_kernels(p)
            order = list(runs) + list(runs)[::-1]
            times = {name: [] for name in runs}
            for name in order:
                times[name].append(cuda_ms(lambda: runs[name](cw, mu, sig),
                                           reps))
            ref = runs["warp"](cw, mu, sig)[0]
            for name, t in times.items():
                w = runs[name](cw, mu, sig)[0]
                ms = float(np.median(t))
                print(json.dumps({
                    "phase": "h1", "shape": label, "body": body,
                    "layout": name, "B": B, "N": N, "iters": p.max_iters,
                    "routed": V._mv_route(1, N, p, False, B)[0]
                    + f":{V.mv_lanes_sweep(B, N)}",
                    "ms": t, "us_per_iter": 1e3 * ms / p.max_iters,
                    "max_abs_dw_warp": (w - ref).abs().max().item()}),
                    flush=True)
        del cw, mu, sig
    for i, (label, B, N, which) in enumerate(H1_SHAPES):
        cw, mu, sig = h1_inputs(B, N, 1100 + i)
        for body, p in h1_bodies(which).items():
            time_lanes_exit(label, cw, mu, sig, p)
            if p.adaptive:
                time_balancing(label, cw, mu, sig, p)
        del cw, mu, sig
    for B, N, iters in H1_LADDER:
        for r in D.run_ladder(B, N, iters, reps=reps):
            print(json.dumps({"phase": "mv_ladder", "B": B, "N": N,
                              "iters": iters,
                              "sweep": V.mv_lanes_sweep(B, N), **r}),
                  flush=True)
    for kernel, function in H1_SASS:
        if kernel in SOURCES:
            print(json.dumps(sass_report(kernel, function)), flush=True)


def time_lanes_exit(label, cw, mu, sig, p):
    """The routed lane kernel with and without its sweeps' early exit
    (``lanes_settled``), timed in two rounds of 5 in turns; the outputs must
    agree bit for bit."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    kernel = V._MV_KERNELS[("lanes", p.adaptive)]
    fns = {"exit": kernel.function(),
           "no_exit": without_sweep_exit(
               kernel, "pdhg_mean_variance_lanes.cuh", LANES_SETTLED)}

    def run(fn):
        kernel._fn = fn    # the shipped kernel's launch, this build
        try:
            return V._mv_launch(kernel, cw, mu, sig, p,
                                return_steps=p.adaptive)
        finally:
            kernel._fn = fns["exit"]

    outs = [run(fn) for fn in fns.values()]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs)), (label, p)
    ms = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            ms[name].append(cuda_ms(lambda: run(fn)))
    print(json.dumps({
        "phase": "lanes_sweep_exit", "shape": label, "B": cw.shape[0],
        "N": cw.shape[1], "adaptive": p.adaptive, "iters": p.max_iters,
        "ms": ms, "no_exit_over_exit": float(np.median(ms["no_exit"])
                                             / np.median(ms["exit"])),
        "same_bits": True}), flush=True)


def time_balancing(label, cw, mu, sig, p):
    """What the adaptive body's balancing costs: the routed lane kernel's
    adaptive body as ``p`` sets it, the same body balancing never
    (``adapt_every`` past the iterations) and the fixed-step body at the
    same iterations and sweep budget, timed in two rounds of 5 in turns."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import mv_cuda as V

    runs = {"adaptive": p,
            "adaptive_never_balancing": replace(
                p, adapt_every=p.max_iters + 1),
            "fixed": replace(p, adaptive=False, adapt_every=1,
                             proj_refresh_every=0)}
    ms = {name: [] for name in runs}
    for _ in range(2):
        for name, q in runs.items():
            ms[name].append(cuda_ms(lambda: V._mv_launch(
                V._MV_KERNELS[("lanes", q.adaptive)], cw, mu, sig, q)))
    print(json.dumps({
        "phase": "lanes_balancing", "shape": label, "B": cw.shape[0],
        "N": cw.shape[1], "iters": p.max_iters, "adapt_every": p.adapt_every,
        "ms": ms, "us_per_iter": {k: 1e3 * float(np.median(v)) / p.max_iters
                                  for k, v in ms.items()}}), flush=True)


# The H=1 kernels' loops read by ``--h1``: the warp layout's at K=1, both
# bodies; the lane layout's at the path's N=20 (NC=24: the in-lane and the
# butterfly sweep, both bodies) and bench.py's N=30 (NC=32, butterfly);
# the ladder's sigma and in-lane proj rungs at N=20, unroll 4, one chain.
H1_SASS = (
    ("pdhg_mean_variance", r"pdhg_mean_variance_kernelILi1ELi1ELb0E"),
    ("pdhg_mean_variance_adaptive",
     r"pdhg_mean_variance_kernelILi1ELi1ELb1E"),
    ("pdhg_mean_variance_lanes",
     r"pdhg_mean_variance_lanes_kernelILi1ELi24ELb0ELb1E"),
    ("pdhg_mean_variance_lanes",
     r"pdhg_mean_variance_lanes_kernelILi1ELi24ELb0ELb0E"),
    ("pdhg_mean_variance_lanes",
     r"pdhg_mean_variance_lanes_kernelILi1ELi32ELb0ELb0E"),
    ("pdhg_mean_variance_lanes_adaptive",
     r"pdhg_mean_variance_lanes_kernelILi1ELi24ELb1ELb0E"),
    ("pdhg_mean_variance_lanes_adaptive",
     r"pdhg_mean_variance_lanes_kernelILi1ELi24ELb1ELb1E"),
    ("mv_ladder", r"mv_ladder_kernelILi1ELi24ELi1ELi4ELi1E"),
    ("mv_ladder", r"mv_ladder_kernelILi1ELi24ELi3ELi4ELi1E"),
)


# --scen: kernel B's warp layout at H=8, N=64 over S, at B=1 and 132 (the
# warp path's shape is S=113, B=132); its block layout at the block path's
# S=16, H=5, N=150; the three bodies at 200 iterations.
SCEN_ITERS = 200
SCEN_BODIES = {
    "fixed": MPCParams(sigma_scale=2.0, max_iters=SCEN_ITERS),
    "pipe": MPCParams(sigma_scale=2.0, max_iters=SCEN_ITERS,
                      proj_refresh_every=16, precond=True,
                      pipeline_reduces=True),
    "adaptive": MPCParams(sigma_scale=2.0, max_iters=SCEN_ITERS,
                          adaptive=True, adapt_every=2, precond=True),
}
SCEN_WARP = ((8, 64), (16, 64, 113), (1, 132))       # (H, N), S, B
SCEN_BLOCK = ((5, 150), 16, (1, 1028))
# The streaming read: (CTAs, problems B of the array, S, H, N, passes).
STREAM_CASES = ((132, 132, 113, 8, 64, 20), (264, 132, 113, 8, 64, 20),
                (1028, 1028, 512, 5, 20, 4), (900, 900, 113, 8, 64, 4))
STREAM_SRC = r"""
// Each warp (horizon row t of problem blockIdx.x % B) reads its row of a
// [B][S][H][N] float array, S rows of N floats H * N apart, by 4-byte
// cp.async with zero-fill past N into a ring of three shared-memory stages
// of C = 16 / K scenarios of K * 32 floats, `passes` times over, and sums
// what it reads so that the loads stay.
#include <cuda_runtime.h>
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
template <int K>
__global__ void stream_rows(const float* r, int B, int S, int H, int N,
                            int passes, float* out) {
  extern __shared__ float smem[];
  constexpr int C = 16 / K, KW = K * 32, STAGE = C * KW;
  const int lane = threadIdx.x & 31, t = threadIdx.x >> 5;
  const int b = blockIdx.x % B;
  float* const ring = smem + t * 3 * STAGE;
  const int chunks = (S + C - 1) / C, total = chunks * passes;
  auto issue = [&](int g) {
    if (g < total) {
      const int s0 = (g % chunks) * C;
      float* const dst = ring + (g % 3) * STAGE;
      for (int s = 0; s < C; ++s)
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          const bool ok = i < N && s0 + s < S;
          cp4(dst + s * KW + k * 32 + lane,
              ok ? r + (((size_t)b * S + s0 + s) * H + t) * N + i : r, ok);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(0);
  issue(1);
  float acc = 0.f;
  for (int g = 0; g < total; ++g) {
    issue(g + 2);
    asm volatile("cp.async.wait_group 2;\n" ::);
    const float* const x = ring + (g % 3) * STAGE;
    for (int j = 0; j < C * K; ++j) acc += x[j * 32 + lane];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (acc == 1234.5f) out[blockIdx.x] = acc;
}
extern "C" int launch_stream_rows(const void* r, int ctas, int B, int S,
                                  int H, int N, int passes, void* out) {
  const int K = (N + 31) / 32;
  const int smem = H * 3 * 16 * 32 * 4;
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kernel<<<ctas, H * 32, smem>>>(static_cast<const float*>(r), B, S, H, N,
                                   passes, static_cast<float*>(out));
    return (int)cudaGetLastError();
  };
  if (K == 1) return run(stream_rows<1>);
  if (K == 2) return run(stream_rows<2>);
  if (K == 4) return run(stream_rows<4>);
  return (int)cudaErrorInvalidValue;
}
"""


def _stream_fn():
    """The plain streaming kernel, built from STREAM_SRC into the build
    directory."""
    import ctypes

    out = BUILD_DIR / "libstream_rows.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / "stream_rows.cu"
        src.write_text(STREAM_SRC)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).launch_stream_rows
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scen_inputs(rng, B, S, H, N):
    cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                         .astype(np.float32), device="cuda")
    ys = (rng.standard_normal((B, S, H, N)) * 0.01).astype(np.float32)
    return cw, torch.exp(torch.as_tensor(ys, device="cuda")).contiguous()


def time_scen():
    """One line per (layout, body, S, B): kernel B's warp and block
    kernels' ms and us an iteration; then one line per streaming case."""
    rng = np.random.default_rng(113)
    (H, N), scens, batches = SCEN_WARP
    cases = [("warp", S, B, H, N) for S in scens for B in batches]
    (Hb, Nb), Sb, bb = SCEN_BLOCK
    cases += [("block", Sb, B, Hb, Nb) for B in bb]
    for layout, S, B, H_, N_ in cases:
        cw, r = _scen_inputs(rng, B, S, H_, N_)
        for body, p in SCEN_BODIES.items():
            kernel = M._KERNELS[(True, layout, body)]
            ms = cuda_ms(lambda: M._launch(kernel, body, cw, r, p, None,
                                           None, False, False))
            print(json.dumps({
                "phase": "scen", "layout": layout, "body": body,
                "kernel": kernel.name, "B": B, "S": S, "H": H_, "N": N_,
                "chain": S * (1 << max(H_ - 1, 0).bit_length()),
                "iters": p.max_iters, "ms": ms,
                "us_per_iter": 1e3 * ms / p.max_iters}), flush=True)
    fn = _stream_fn()
    for ctas, B, S, H_, N_, passes in STREAM_CASES:
        x = torch.rand((B, S, H_, N_), device="cuda")
        out = torch.zeros(ctas, device="cuda")

        def run():
            err = fn(x.data_ptr(), ctas, B, S, H_, N_, passes,
                     out.data_ptr())
            assert err == 0, err

        ms = cuda_ms(run)
        read = ctas * S * H_ * N_ * 4 * passes
        print(json.dumps({
            "phase": "stream", "ctas": ctas, "B": B, "S": S, "H": H_,
            "N": N_, "array_bytes": x.numel() * 4, "passes": passes,
            "ms": ms, "us_per_pass": 1e3 * ms / passes,
            "tb_per_s": read / (ms * 1e-3) / 1e12}), flush=True)


# --digest: the one-forecast wide kernels' bits, (label, B, H, N, seed,
# bodies).
DIGEST_CASES = (("block_path_N150", 1028, 5, 150, 1150,
                 ("fixed", "pipe", "adaptive")),
                ("assets500", 4096, 5, 500, 0, ("pipe",)))


def _digest_inputs():
    """[(case_body, cw, r, body)] of DIGEST_CASES on the card."""
    out = []
    for label, B, H, N_, seed, bodies in DIGEST_CASES:
        rng = np.random.default_rng(seed)
        cw = torch.as_tensor(rng.dirichlet(np.ones(N_), size=B)
                             .astype(np.float32), device="cuda")
        ys = (rng.standard_normal((B, H, N_)) * 0.01 + 0.0005)
        r = torch.exp(torch.as_tensor(ys.astype(np.float32),
                                      device="cuda")).contiguous()
        out += [(f"{label}_{body}", cw, r, body) for body in bodies]
    return out


def _digest_outputs(cases) -> dict:
    """{case_body: (SHA-256 hex, the outputs as numpy arrays)}."""
    out = {}
    for name, cw, r, body in cases:
        p = WIDE_BODIES[body]
        kernel = M._KERNELS[(False, "wide", body)]
        res = M._launch(kernel, body, cw, r, p, None, None, True, p.adaptive)
        torch.cuda.synchronize()
        host = [x.cpu().numpy() for x in res]
        h = hashlib.sha256()
        for x in host:
            h.update(x.tobytes())
        out[name] = (h.hexdigest(), host)
    return out


def wide_digests() -> dict:
    """{case_body: SHA-256 hex of the wide kernel's outputs}, through the
    private launch ``M._launch`` of ``M._KERNELS[(False, "wide", body)]``
    (whose signature the wide layout has kept since it came)."""
    return {k: v[0] for k, v in _digest_outputs(_digest_inputs()).items()}


# The load of ``digests_beside_busy``: the float64 polished path on the
# card, over and over, until the process is killed.
_BUSY = """
import numpy as np, torch
from kmpc_tpu_torch.ops.mpc import MPCParams
from kmpc_tpu_torch.ops.mpc_polish import solve_mpc_log_utility_batch_polished
from kmpc_tpu_torch.parity_cdf import REPO_CACHE, polish_order
d = np.load(REPO_CACHE / "instances_{family}_1000.npz")
ids = polish_order(d["cw"].shape[0])[:32]
p = MPCParams(max_iters=30000, sigma_scale=2.0, ridge=1e-3, polish=True,
              polish_newton=4)
cw = torch.as_tensor(d["cw"][ids], device="cuda")
ys = torch.as_tensor(d["ys"][ids], device="cuda")
while True:
    solve_mpc_log_utility_batch_polished(cw, ys, p, cycles=3)
"""


def digests_beside_busy(seconds: float) -> None:
    """``--digest --busy``: one JSON line a step (module docstring)."""
    def far(a, b):
        return [float(np.abs(x.astype(np.float64) - y).max())
                for x, y in zip(a, b)]

    def report(step, got, base, **kw):
        print(json.dumps({"phase": "wide_digest_busy", "step": step,
                          "same_bits": {k: v[0] == base[k][0]
                                        for k, v in got.items()}, **kw}),
              flush=True)

    cases = _digest_inputs()
    base = _digest_outputs(cases)
    report("alone", _digest_outputs(cases), base)
    plain = {}
    for name, cw, r, body in cases:
        out = M.pdhg_log_utility_plain(cw, r, WIDE_BODIES[body],
                                       return_dual=True)
        plain[name] = [x.cpu().numpy().astype(np.float64) for x in out]
    print(json.dumps({"phase": "wide_digest_busy", "step": "plain",
                      "max_abs_diff_w_fp_dual": {
                          k: far(v[1][:3], plain[k])
                          for k, v in base.items()}}), flush=True)
    del cases
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 28,), float("nan"), device="cuda")]
    junk += [torch.full((1 << 17,), float("nan"), device="cuda")
             for _ in range(2000)]
    del junk
    cases = _digest_inputs()
    report("nan_filled_allocator", _digest_outputs(cases), base)
    procs = [subprocess.Popen([sys.executable, "-c",
                               _BUSY.format(family=f)],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for f in ("realistic", "random")]
    rounds, changed = 0, []
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            got = _digest_outputs(cases)
            rounds += 1
            changed += [{"round": rounds, "case": k,
                         "from_alone": far(v[1], base[k][1]),
                         "from_plain": far(v[1][:3], plain[k])}
                        for k, v in got.items() if v[0] != base[k][0]]
        running = [p.poll() is None for p in procs]
    finally:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-400:] for p in procs]
    print(json.dumps({"phase": "wide_digest_busy", "step": "beside_busy",
                      "seconds": seconds, "rounds": rounds,
                      "busy_running_at_end": running,
                      "changed_rounds": len(changed),
                      "changed": changed[:40], "busy_stderr": errs}),
          flush=True)
    report("after", _digest_outputs(cases), base)


# The global path's shape: (B, H, N), the synthetic 1000-name universe's
# test dates at H=20; kernel B at GLOBAL_S scenarios.
GLOBAL_SHAPE = (1013, 20, 1000)
GLOBAL_S = 16


def _one_launch_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_global(iters: int = 400) -> None:
    """``--global``: one JSON line a kernel (module docstring)."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    B, H, N = GLOBAL_SHAPE
    rng = np.random.default_rng(1513)
    p = MPCParams(sigma_scale=2.0, max_iters=iters)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B).astype(np.float32),
                         device="cuda")
    runs = []
    for S in (None, GLOBAL_S):
        shape = (B, H, N) if S is None else (B, S, H, N)
        ys = rng.standard_normal(shape) * 0.01 + (0.0005 if S is None else 0)
        r = torch.exp(torch.as_tensor(ys.astype(np.float32), device="cuda"))
        kernel = M._KERNELS[(S is not None, "global", "fixed")]
        runs.append((kernel, S, (S or 0, H, N), lambda k, r=r, kernel=kernel:
                     M._launch(kernel, "fixed", cw, r, p, None, None, False,
                               False),
                     M.global_workspace_bytes(S, H, N, 1)))
    mu = torch.as_tensor((rng.standard_normal((B, H, N)) * 0.01)
                         .astype(np.float32), device="cuda")
    A = rng.standard_normal((N, N)) * 0.01
    sig = torch.as_tensor((A @ A.T + np.eye(N) * 1e-4).astype(np.float32),
                          device="cuda")
    pm = MPCParams(sigma_scale=2.0, max_iters=iters, gamma=1.0)
    runs.append((V.PDHG_MEAN_VARIANCE_GLOBAL, None, (H, N),
                 lambda k: V._mv_launch(V.PDHG_MEAN_VARIANCE_GLOBAL, cw, mu,
                                        sig, pm),
                 V.mv_global_workspace_bytes(H, N, 1)))
    keep = M.GLOBAL_CTAS_PER_SM
    for kernel, S, shape, launch, slot in runs:
        launch(kernel)                         # build, warm
        resident = M._OCCUPANCY[(kernel.name, shape, False)]
        times = {1: [], 2: []}
        try:
            for c in (1, 2, 2, 1):
                # The grid policy's one constant, set for this launch.
                M.GLOBAL_CTAS_PER_SM = c
                times[c].append(_one_launch_ms(lambda: launch(kernel)))
        finally:
            M.GLOBAL_CTAS_PER_SM = keep
        grids = {c: min(B, min(c, resident) * sms) for c in (1, 2)}
        line = {"phase": "global_layout", "kernel": kernel.name, "B": B,
                "S": S, "H": H, "N": N, "iters": iters,
                "resident_ctas_per_sm": resident, "sms": sms,
                "grid": grids, "workspace_bytes": {
                    c: slot * g for c, g in grids.items()},
                "ms": times, "us_per_iter": {
                    c: 1e3 * min(t) / iters for c, t in times.items()}}
        if S:
            line["returns_bytes_per_iter"] = 2 * 4 * B * S * H * N
        print(json.dumps(line), flush=True)


def _clusters(kernel, S, H, N, storage, plan, pipe=False) -> int:
    """Clusters of a launch's plan the card runs at once."""
    fn = M._library_function(kernel.name, kernel.symbol + "_clusters",
                             [ctypes.c_int] * 8, ctypes.c_int)
    return fn(S or 0, H, N, M.STORAGES.index(storage), plan[0], plan[3],
              plan[4], int(pipe))


def time_cluster(iters: int = 400) -> None:
    """The cluster lines of ``--global`` (module docstring)."""
    B, H, N = GLOBAL_SHAPE
    rng = np.random.default_rng(1613)
    p = MPCParams(sigma_scale=2.0, max_iters=iters)

    def inputs(S, H, N):
        cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                             .astype(np.float32), device="cuda")
        shape = (B, H, N) if S is None else (B, S, H, N)
        ys = rng.standard_normal(shape) * 0.01 + (0.0005 if S is None else 0)
        return cw, torch.exp(torch.as_tensor(ys.astype(np.float32),
                                             device="cuda")).contiguous()

    def launcher(layout, cw, r, storage=None, ring=None):
        S = r.shape[1] if r.dim() == 4 else None
        kernel = M._KERNELS[(S is not None, layout, "fixed")]
        return kernel, lambda: M._launch(kernel, "fixed", cw, r, p, None,
                                         None, False, False, storage=storage,
                                         ring=ring)

    def turns(a, b):
        """(ms of a, ms of b) in turns a, b, b, a after a warm launch
        each."""
        a(), b()
        times = ([], [])
        for i in (0, 1, 1, 0):
            times[i].append(_one_launch_ms((a, b)[i]))
        return times

    for S in (None, GLOBAL_S):
        cw, r = inputs(S, H, N)
        kg, glob = launcher("global", cw, r)
        rings = [None] if S is None else list(M.CLUSTER_RINGS)
        for ring in rings:
            storage = None if S is None else "streamed"
            kc, clus = launcher("cluster", cw, r, storage, ring)
            plan = M.cluster_plan(S, H, N, False, storage, ring)
            tg, tc = turns(glob, clus)
            line = {"phase": "cluster_layout", "kernel": kc.name, "B": B,
                    "S": S, "H": H, "N": N, "iters": iters,
                    "ctas": plan[0], "rows_a_cta": plan[1],
                    "cta_bytes": plan[2], "ring": plan[3:] if S else None,
                    "clusters_at_once": _clusters(
                        kc, S, H, N, storage or "registers", plan),
                    "ms": tc, "global_ms": tg,
                    "us_per_iter": 1e3 * min(tc) / iters,
                    "global_us_per_iter": 1e3 * min(tg) / iters}
            if S:
                line["returns_bytes_per_iter"] = 4 * B * S * H * N
                line["returns_tb_per_s"] = (line["returns_bytes_per_iter"]
                                            * iters / (min(tc) * 1e-3) / 1e12)
            print(json.dumps(line), flush=True)
        del r
    # Kernel B's storages where both take the shape, and A beside the block
    # layout at H > 32.
    for S, h, n, a_layout, b_layout in ((GLOBAL_S, 20, 500, "cluster:resident",
                                        "cluster:streamed"),
                                       (GLOBAL_S, 33, 128, "cluster:resident",
                                        "cluster:streamed"),
                                       (None, 60, 64, "block", "cluster")):
        cw, r = inputs(S, h, n)
        runs = []
        for lay in (a_layout, b_layout):
            name, _, storage = lay.partition(":")
            runs.append(launcher(name, cw, r, storage or None))
        ta, tb = turns(runs[0][1], runs[1][1])
        print(json.dumps({
            "phase": "cluster_beside", "B": B, "S": S, "H": h, "N": n,
            "iters": iters, "routed": M.kernel_layout(S, h, n),
            "storage_routed": M.cluster_storage(S, h, n) if S else None,
            "plans": {lay: M.cluster_plan(S, h, n, False, lay.partition(
                ":")[2] or None) for lay in (a_layout, b_layout)
                if lay.startswith("cluster")},
            "ms": {a_layout: ta, b_layout: tb},
            "us_per_iter": {a_layout: 1e3 * min(ta) / iters,
                            b_layout: 1e3 * min(tb) / iters}}), flush=True)
        del r


# (B, H, N, shared Sigma): the switch shapes of chip_smoke.py's mv_layouts
# where the block and tile layouts run close, and two on either side.
MV_SWITCH = ((5, 1, 129, True), (1028, 1, 200, False), (1, 1, 200, False),
             (5, 5, 300, False), (5, 5, 320, True), (264, 3, 300, False),
             (1028, 5, 320, True), (1, 1, 960, True))


def time_mv_switch(iters: int = 200) -> None:
    """``--mv-switch``: one JSON line a shape and body."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    rng = np.random.default_rng(129)
    for B, H, N, shared in MV_SWITCH:
        cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B)
                             .astype(np.float32), device="cuda")
        mu = torch.as_tensor((rng.standard_normal((B, H, N)) * 0.01)
                             .astype(np.float32), device="cuda")
        A = rng.standard_normal((N, N) if shared else (B, N, N)) * 0.01
        sig = torch.as_tensor((A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4)
                              .astype(np.float32), device="cuda")
        for adaptive in (False, True):
            p = MPCParams(sigma_scale=2.0, gamma=1.0, max_iters=iters,
                          adaptive=adaptive, adapt_every=2)
            ms = {}
            for layout in ("block", "tile"):
                kernel = V._MV_KERNELS[(layout, adaptive)]
                ms[layout] = cuda_ms(
                    lambda: V._mv_launch(kernel, cw, mu, sig, p))
            out = V._mv_launch(V._MV_KERNELS[("block", adaptive)], cw, mu,
                               sig, p)
            digest = hashlib.sha256(b"".join(
                t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]
            print(json.dumps({"phase": "mv_switch", "B": B, "H": H, "N": N,
                              "shared": shared, "adaptive": adaptive,
                              "iters": iters, "ms": ms,
                              "block_digest": digest}), flush=True)
    # The block kernels' registers, spills and SASS (the simplex
    # projection's instantiation, in either checkout's mangling).
    for adaptive in (False, True):
        name = "pdhg_mean_variance_block" + ("_adaptive" if adaptive else "")
        print(json.dumps(sass_report(
            name, rf"pdhg_mean_variance_block_kernelILb{int(adaptive)}E"
            r"(Lb0E)?E")), flush=True)


# --mv-cluster: kernel C's cluster layout. The bits first, at small
# batches: (B, H, N, shared, the layout of the same body whose bits it must
# give). Then the times: (B, H, N, shared) at one row past the block
# layout's staging (N = 240, 500, 1000 at B = 32, 132, 1013) and at the
# global layout's shapes (H=20 N=1000 at B = 32 and 1013, H=33 N=500).
MV_CLUSTER_BITS = ((5, 1, 300, False, "block"), (4, 1, 1000, True, "block"),
                   (3, 20, 1000, False, "global"),
                   (3, 33, 500, True, "global"), (5, 3, 150, False, "block"))
MV_CLUSTER_SHAPES = tuple(
    (B, 1, N, shared) for N in (240, 500, 1000) for B in (32, 132, 1013)
    for shared in (False, True)) + (
    (32, 20, 1000, False), (32, 20, 1000, True), (1013, 20, 1000, False),
    (1013, 20, 1000, True), (132, 33, 500, False), (132, 33, 500, True))


def _mv_cluster_inputs(B, H, N, shared, seed):
    """Current weights, mu and a symmetric covariance made on the card
    (chip_smoke.py's ``mv_instance_cuda`` distribution, scale 0.01)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = torch.empty((B, N), device="cuda").exponential_(generator=g)
    cw = e / e.sum(-1, keepdim=True)
    mu = torch.randn((B, H, N), generator=g, device="cuda") * 0.01
    A = torch.randn((N, N) if shared else (B, N, N), generator=g,
                    device="cuda") * 0.01
    sig = A @ A.transpose(-1, -2) + 1e-4 * torch.eye(N, device="cuda")
    del A
    return cw, mu, (0.5 * (sig + sig.transpose(-1, -2))).contiguous()


def mv_cluster_bits() -> None:
    """The cluster kernels at every size their plan takes, against the
    block or global kernel of the same body on the same inputs: one line
    a case with whether the bits are equal (weights, fixed-point residuals,
    steps) and the largest weight difference."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    for B, H, N, shared, other in MV_CLUSTER_BITS:
        cw, mu, sig = _mv_cluster_inputs(B, H, N, shared, 17 * N + H)
        for adaptive in (False, True):
            p = MPCParams(sigma_scale=2.0, gamma=5.0, max_iters=300,
                          adaptive=adaptive, adapt_every=2,
                          proj_refresh_every=0 if adaptive else 16)
            ref = V._mv_launch(V._MV_KERNELS[(other, adaptive)], cw, mu,
                               sig, p, return_steps=adaptive)
            for C in V.mv_cluster_sizes(H, N, adaptive):
                line = {"phase": "mv_cluster_bits", "B": B, "H": H, "N": N,
                        "shared": shared, "adaptive": adaptive, "C": C,
                        "against": other,
                        "plan": V.mv_cluster_plan(H, N, C, adaptive)}
                try:
                    out = V._mv_launch(V._MV_KERNELS[("cluster", adaptive)],
                                       cw, mu, sig, p, return_steps=adaptive,
                                       cluster_ctas=C)
                    torch.cuda.synchronize()
                    line["bits_equal"] = all(
                        torch.equal(x, y) for x, y in zip(out, ref))
                    line["max_abs_dw"] = (out[0] - ref[0]).abs().max().item()
                    line["max_abs_dfp"] = (out[1] - ref[1]).abs().max().item()
                except (RuntimeError, ValueError) as e:
                    line["error"] = str(e)
                print(json.dumps(line), flush=True)


def time_mv_cluster(iters: int = 200) -> None:
    """``--mv-cluster``: the bits (``mv_cluster_bits``), then one line a
    shape and body: each layout that takes it (block, tile, global, and the
    cluster layout at each of 2, 4, 8 and 16 CTAs its plan takes), timed
    in turns
    (two rounds after a warm launch each), with the routed layout, each
    cluster size's clusters at once, rows of Sigma staged, and the bytes of
    Sigma read from L2 an iteration (the rows past the staged ones, once
    per eight horizon rows) with the rate the fastest cluster launch read
    them at."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    mv_cluster_bits()
    for B, H, N, shared in MV_CLUSTER_SHAPES:
        cw, mu, sig = _mv_cluster_inputs(B, H, N, shared, B + N + H)
        it = iters if H == 1 else iters // 2 if B <= 132 else iters // 4
        for adaptive in (False, True):
            p = MPCParams(sigma_scale=2.0, gamma=1.0, max_iters=it,
                          adaptive=adaptive, adapt_every=2)
            runs = {}
            for layout in ("block", "tile", "global"):
                if layout == "block" and V.mv_block_smem_bytes(H, N) > \
                        V.SMEM_PER_BLOCK:
                    continue
                if layout == "tile" and not V.mv_tile_problems(
                        B, H, N, shared, adaptive):
                    continue
                kernel = V._MV_KERNELS[(layout, adaptive)]
                runs[layout] = (lambda k=kernel: V._mv_launch(
                    k, cw, mu, sig, p))
            kc = V._MV_KERNELS[("cluster", adaptive)]
            info = {}
            for C in V.mv_cluster_sizes(H, N, adaptive):
                if C not in (2, 4, 8, 16) or V.mv_cluster_clusters(
                        kc, H, N, C, "cuda") < 1:
                    continue
                plan = V.mv_cluster_plan(H, N, C, adaptive)
                runs[f"cluster:{C}"] = (lambda C=C: V._mv_launch(
                    kc, cw, mu, sig, p, cluster_ctas=C))
                info[C] = {"clusters_at_once": V.mv_cluster_clusters(
                    kc, H, N, C, "cuda"), "rows_staged": plan[3],
                    "l2_bytes_per_problem_iter": 4 * (N - plan[3]) * N
                    * -(-H // 8)}
            for run in runs.values():
                run()
            times = {k: [] for k in runs}
            for _ in range(2):
                for k, run in runs.items():
                    times[k].append(_one_launch_ms(run))
            best = {k: min(t) for k, t in times.items()}
            for C, d in info.items():
                t = best[f"cluster:{C}"] * 1e-3
                d["l2_tb_per_s"] = (d["l2_bytes_per_problem_iter"] * B * it
                                    / t / 1e12)
            print(json.dumps({
                "phase": "mv_cluster", "B": B, "H": H, "N": N,
                "shared": shared, "adaptive": adaptive, "iters": it,
                "routed": V.mv_kernel_layout(H, N, shared, adaptive, B),
                "routed_ctas": V.mv_cluster_ctas(H, N, adaptive, B),
                "ms": times, "us_per_iter": {
                    k: 1e3 * v / it for k, v in best.items()},
                "fastest": min(best, key=best.get), "cluster": info}),
                flush=True)
        del cw, mu, sig
        torch.cuda.empty_cache()


# --mv-cluster-cuts: the cluster kernel's fixed body with one part cut out
# (its outputs wrong, its time the point): name -> (text of
# csrc/pdhg_mean_variance_cluster.cuh, its replacement). The rows of Sigma
# read from global memory, the staged rows, the whole product, the remote
# writes of w.
MV_CLUSTER_CUTS = {
    "no_remainder": (
        "  for (int j0 = js; j0 < N; j0 += 2 * G) {\n",
        "  for (int j0 = N; j0 < N; j0 += 2 * G) {\n"),
    "no_staged": (
        "  for (int j = 0; j < jv; j += V) {\n",
        "  for (int j = 0; j < 0; j += V) {\n"),
    "no_product": ("    mv_cluster_rows<KS, RB>(ra);\n", ""),
    "no_publish": (
        "    for (int k = 0; k < P.C; ++k)\n"
        "      if (k != rank) cl.map_shared_rank(w, k)[e] = x;\n", ""),
}
# (B, C, iterations): one wave of the global path's Markowitz shape (H=1,
# N=1000, a covariance per problem) at 16 and 8 CTAs, then its 1013 dates
# at 16, 8 and 2.
MV_CLUSTER_CUT_SHAPES = ((7, 16, 200), (15, 8, 200), (1013, 16, 20),
                         (1013, 8, 20), (1013, 2, 20))


def mv_cluster_cut(name: str):
    """The fixed-step cluster kernel's function built from a copy of the
    sources (in the build directory) with ``MV_CLUSTER_CUTS[name]`` applied
    (none for "full"), bound as the package binds it."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    kernel = V.PDHG_MEAN_VARIANCE_CLUSTER
    out = BUILD_DIR / f"lib{kernel.name}_cut_{name}.so"
    src = BUILD_DIR / f"cut_src_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    if name != "full":
        header = src / "pdhg_mean_variance_cluster.cuh"
        text = header.read_text()
        cut, by = MV_CLUSTER_CUTS[name]
        assert text.count(cut) == 1, f"{name}: the cut's text not found"
        header.write_text(text.replace(cut, by))
    return subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(out),
         str(src / SOURCES[kernel.name])],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL), out


def time_mv_cluster_cuts() -> None:
    """``--mv-cluster-cuts``: one line a (B, C) of ``MV_CLUSTER_CUT_SHAPES``
    with the us an iteration of the whole kernel and of each cut
    (``MV_CLUSTER_CUTS``), at the fixed body's three warm Michelot sweeps
    an iteration and at none (the threshold carried unchanged): where an
    iteration of the cluster layout goes."""
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops.mpc_cuda import _sweep_budgets

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {n: mv_cluster_cut(n) for n in ("full", *MV_CLUSTER_CUTS)}
    fns = {}
    for n, (proc, out) in builds.items():
        assert proc.wait() == 0, f"{n}: nvcc failed"
        fn = getattr(ctypes.CDLL(str(out)),
                     V.PDHG_MEAN_VARIANCE_CLUSTER.symbol)
        fn.argtypes = V.PDHG_MEAN_VARIANCE_CLUSTER.argtypes
        fn.restype = ctypes.c_int
        fns[n] = fn
    H, N = 1, 1000
    for B, C, it in MV_CLUSTER_CUT_SHAPES:
        cw, mu, sig = _mv_cluster_inputs(B, H, N, False, 7)
        p = MPCParams(sigma_scale=2.0, gamma=1.0, max_iters=it)
        _, _, cold = _sweep_budgets(p, N)
        w, fp = torch.empty_like(mu), torch.empty(B, device="cuda")
        us = {}
        for sweeps in (p.proj_warm_iters, 0):
            for n, fn in fns.items():
                def run(fn=fn, sweeps=sweeps):
                    e = fn(cw.data_ptr(), mu.data_ptr(), sig.data_ptr(),
                           w.data_ptr(), fp.data_ptr(), B, H, N, 0, it, 0,
                           sweeps, cold, p.cost_coeff, p.gamma, p.over_relax,
                           p.step_scale, p.sigma_scale, 1, C,
                           torch.cuda.current_stream().cuda_stream)
                    assert e == 0, e
                run()
                us[f"{n}:sweeps{sweeps}"] = 1e3 * min(
                    _one_launch_ms(run) for _ in range(2)) / it
        print(json.dumps({"phase": "mv_cluster_cuts", "B": B, "H": H,
                          "N": N, "C": C, "iters": it,
                          "us_per_iter": us}), flush=True)
        del cw, mu, sig, w
        torch.cuda.empty_cache()


def plain_replay_bits() -> None:
    """``--plain-replay``: one JSON line (module docstring)."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    def ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    rng = np.random.default_rng(0)
    B, S, H, N = 1028, 16, 5, 20
    cw = rng.dirichlet(np.ones(N), size=B)
    r = np.exp(rng.standard_normal((B, H, N)) * 0.01 + 5e-4)
    rs = np.exp(rng.standard_normal((B, S, H, N)) * 0.01 + 5e-4)
    mu = rng.standard_normal((B, 1, N)) * 0.01
    a = rng.standard_normal((B, N, N))
    sig = a @ a.transpose(0, 2, 1) * 0.01
    bodies = {
        "fixed": MPCParams(max_iters=2000, sigma_scale=2.0),
        "refresh": MPCParams(max_iters=1003, sigma_scale=2.0,
                             proj_refresh_every=16, precond=True),
        "pipe": MPCParams(max_iters=1003, sigma_scale=2.0,
                          proj_refresh_every=16, precond=True,
                          pipeline_reduces=True),
        "adaptive": MPCParams(max_iters=801, sigma_scale=2.0, adaptive=True,
                              adapt_every=2, precond=True),
    }
    rows = []
    for body, p in bodies.items():
        for dt in (torch.float32, torch.float64):
            def t(x):
                return torch.as_tensor(x, dtype=dt, device="cuda")

            runs = {
                "A": lambda: M.pdhg_log_utility_plain(
                    t(cw), t(r), p, return_dual=True,
                    return_steps=p.adaptive),
                "B": lambda: M.pdhg_log_utility_plain(
                    t(cw), t(rs), p, return_dual=True,
                    return_steps=p.adaptive),
                "C": lambda: V.pdhg_mean_variance_plain(
                    t(cw), t(mu), t(sig), p, return_steps=p.adaptive)}
            for kernel, run in runs.items():
                eager, eager_ms = ms(run)
                with M.plain_replayed():
                    replayed, replayed_ms = ms(run)
                rows.append({"kernel": kernel, "body": body,
                             "dtype": str(dt).split(".")[-1],
                             "bits_equal": all(torch.equal(x, y) for x, y
                                               in zip(eager, replayed)),
                             "eager_ms": eager_ms,
                             "replayed_ms": replayed_ms})
    print(json.dumps({"phase": "plain_replay", "B": B, "S": S, "H": H,
                      "N": N, "all_bits_equal": all(
                          x["bits_equal"] for x in rows), "runs": rows}),
          flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layouts", default="warp,rows")
    parser.add_argument("--wide", action="store_true",
                        help="the block and wide layouts past 128 assets")
    parser.add_argument("--boundary", metavar="H,H:N,N",
                        help="the wide/block grid alone, at these H and N")
    parser.add_argument("--mv", action="store_true",
                        help="kernel C's block and tile layouts at N=960")
    parser.add_argument("--scen", action="store_true",
                        help="kernel B's warp and block layouts, and a "
                             "streaming read")
    parser.add_argument("--h1", action="store_true",
                        help="kernel C at one horizon row and the MV "
                             "ladder at its paths' shapes")
    parser.add_argument("--digest", action="store_true",
                        help="a digest of the one-forecast wide kernels' "
                             "outputs")
    parser.add_argument("--plain-replay", action="store_true",
                        help="the plain versions eager and replayed as "
                             "CUDA graphs: bits and times")
    parser.add_argument("--global", dest="global_", action="store_true",
                        help="the global layout at the global path's shape, "
                             "one and two CTAs an SM")
    parser.add_argument("--mv-switch", action="store_true",
                        help="kernel C's block and tile layouts at the "
                             "switch shapes where they run close")
    parser.add_argument("--mv-cluster", action="store_true",
                        help="kernel C's cluster layout: its bits against "
                             "the block and global kernels, its times "
                             "beside theirs at the cluster's shapes")
    parser.add_argument("--mv-cluster-cuts", action="store_true",
                        help="kernel C's cluster layout with one part cut "
                             "out at a time: where an iteration goes")
    parser.add_argument("--busy", type=float, metavar="SECONDS",
                        help="with --digest: the digests with a NaN-filled "
                             "allocator, then for SECONDS beside two "
                             "processes running the polished path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("row_slots: CUDA is not available")
    if args.wide or args.boundary or args.mv or args.scen or args.digest \
            or args.h1 or args.plain_replay or args.global_ \
            or args.mv_switch or args.mv_cluster or args.mv_cluster_cuts:
        print(json.dumps({"phase": "device", "smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()}), flush=True)
    if args.plain_replay:
        plain_replay_bits()
        return
    if args.global_:
        time_global()
        time_cluster()
        return
    if args.mv_switch:
        time_mv_switch()
        return
    if args.mv_cluster:
        time_mv_cluster()
        return
    if args.mv_cluster_cuts:
        time_mv_cluster_cuts()
        return
    if args.digest:
        print(json.dumps({"phase": "wide_digest", **wide_digests()}),
              flush=True)
        if args.busy:
            digests_beside_busy(args.busy)
        return
    if args.scen:
        time_scen()
        return
    if args.h1:
        time_h1()
        return
    if args.mv:
        time_mv()
        return
    if args.boundary:
        hs, ns = args.boundary.split(":")
        wide_boundary(tuple(int(h) for h in hs.split(",")),
                      tuple(int(n) for n in ns.split(",")))
        return
    if args.wide:
        time_wide(["block", "wide"])
        wide_boundary()
        for kernel, function in WIDE_SASS:
            print(json.dumps(sass_report(kernel, function)), flush=True)
        return
    time_layouts(args.layouts.split(","))
    for kernel, function in SASS:
        print(json.dumps(sass_report(kernel, function)), flush=True)
    time_sweep_exit()


if __name__ == "__main__":
    main()
