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

    python -m kmpc_tpu_torch.ops.row_slots [--layouts warp,rows]

One JSON line per measurement; needs the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
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
    "MUFU.RCP": r"\bMUFU\.RCP\b",
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


def without_sweep_exit(kernel):
    """The function of the row kernel ``kernel`` built from a copy of the
    sources (in the build directory) whose ``settled`` returns false, so
    that every projection runs its full budget of sweeps, bound as the
    package binds it."""
    import ctypes

    out = library_path(kernel.name).with_name(
        library_path(kernel.name).stem + "_no_exit.so")
    if not out.exists():
        src = BUILD_DIR / "no_exit_src"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        header = src / "pdhg_log_utility_rows.cuh"
        text = header.read_text()
        assert text.count(SETTLED) == 1, "settled() not found"
        header.write_text(text.replace(SETTLED, "  return false;\n"))
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layouts", default="warp,rows")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("row_slots: CUDA is not available")
    time_layouts(args.layouts.split(","))
    for kernel, function in SASS:
        print(json.dumps(sass_report(kernel, function)), flush=True)
    time_sweep_exit()


if __name__ == "__main__":
    main()
