"""Every kernel launch runs on the card its tensors sit on.

A rank of a multi-card world whose tensors sit on cuda:k must launch there
whichever card is current. ``CudaKernel.launch`` (``kmpc_tpu_torch/_build.py``)
makes the tensors' card current for the call and passes that card's
stream; every wrapper launches through it. On the CPU the CUDA calls are
recorded by stand-ins; the card case needs two cards and skips otherwise.
Imports neither JAX nor kmpc_tpu, so it runs on the H100 machine too
(``python -m pytest tests/test_torch_port_launch.py --noconftest``).
"""

import ast
from pathlib import Path

import pytest
import torch

from kmpc_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent
WRAPPERS = ("kmpc_tpu_torch/ops/mpc_cuda.py", "kmpc_tpu_torch/ops/mv_cuda.py",
            "kmpc_tpu_torch/ops/mv_ladder.py")


class _Recorder:
    """Stand-ins for torch.cuda.device and torch.cuda.current_stream that
    record which card is current."""

    def __init__(self):
        self.current = "cuda:0"
        self.calls = []

    def device(self, d):
        rec = self

        class _Guard:
            def __enter__(self):
                self.prev, rec.current = rec.current, str(d)

            def __exit__(self, *exc):
                rec.current = self.prev

        return _Guard()

    def current_stream(self, d):
        return type("Stream", (), {"cuda_stream": f"stream of {d}"})()

    def kernel(self, rc=0):
        def fn(*args):
            self.calls.append((self.current, args))
            return rc
        return fn


def test_launch_makes_the_tensors_card_current(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_stream", rec.current_stream)
    kernel = _build.CudaKernel("pdhg_log_utility_rows", "unused", [])
    kernel._fn = rec.kernel()
    kernel.launch(torch.device("cuda", 1), 7, 8)
    assert rec.calls == [("cuda:1", (7, 8, "stream of cuda:1"))]
    assert rec.current == "cuda:0" and kernel.launches == 1
    kernel._fn = rec.kernel(rc=700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernel.launch(torch.device("cuda", 1))
    assert kernel.launches == 1   # a failed launch is not counted


@pytest.mark.parametrize("rel", WRAPPERS)
def test_wrappers_launch_only_through_the_guard(rel):
    """No wrapper calls a kernel's C function itself: each launch goes
    through ``CudaKernel.launch`` with its tensors' device."""
    tree = ast.parse((ROOT / rel).read_text())
    direct = [n.lineno for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr in ("function", "cuda_stream")]
    assert not direct, f"{rel} launches outside CudaKernel.launch: {direct}"
    launches = [n for n in ast.walk(tree)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "launch"]
    assert launches
    for call in launches:
        dev = call.args[0]
        assert isinstance(dev, ast.Attribute) and dev.attr == "device", \
            f"{rel}:{call.lineno} launches on {ast.unparse(dev)}"


@pytest.mark.cuda
def test_solve_on_another_card_than_the_current_one():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed

    g = torch.Generator().manual_seed(0)
    cw = torch.softmax(torch.randn(64, 20, generator=g), -1)
    ys = 0.01 * torch.randn(64, 5, 20, generator=g)
    params = MPCParams(max_iters=300)
    outs = []
    for current in (1, 0):
        with torch.cuda.device(current):
            w, _ = solve_mpc_log_utility_packed(cw, ys, params, device="cuda:1")
            torch.cuda.synchronize(1)
        assert w.device == torch.device("cuda", 1)
        outs.append(w.cpu())
    assert torch.equal(outs[0], outs[1])


def test_a_world_that_fails_or_hangs_is_killed(monkeypatch):
    """A rank that fails fails the world (its exit code and standard error
    reported, the others killed); a world past its time limit is killed
    whole and raises TimeoutError."""
    import sys
    import time

    from kmpc_tpu_torch.parallel import launch as L
    from kmpc_tpu_torch.parallel.launch import launch

    monkeypatch.setattr(L, "GRACE_S", 1.0)

    outs = launch([sys.executable, "-c",
                   "import os; print(os.environ['RANK'], "
                   "os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'])"],
                  world=2, timeout=60)
    assert [o.split() for o in outs] == [["0", "2", "0"], ["1", "2", "1"]]
    failing = ("import os, sys, time\n"
               "if os.environ['RANK'] == '1':\n"
               "    sys.exit('rank one gives up')\n"
               "time.sleep(600)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ranks \\[1\\] of 2 failed"
                       "(.|\\n)*rank one gives up"):
        launch([sys.executable, "-c", failing], world=2, timeout=20)
    with pytest.raises(TimeoutError, match="still running"):
        launch([sys.executable, "-c", "import time; time.sleep(600)"],
               world=2, timeout=2)
    assert time.monotonic() - t0 < 30
