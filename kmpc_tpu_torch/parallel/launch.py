"""Start the ranks of a world on this machine, as ``torchrun`` does.

    from kmpc_tpu_torch.parallel.launch import launch
    outs = launch([sys.executable, "-m", "kmpc_tpu_torch.parallel.dryrun",
                   "--world", "4", "--cpu"], world=4, timeout=180)

Each rank is a process of its own with ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` (127.0.0.1) and ``MASTER_PORT`` (a free
port) set, which :func:`~kmpc_tpu_torch.parallel.initialize_distributed`
reads. On the card that is one rank a card (``LOCAL_RANK`` names it); on the
CPU, gloo ranks. A world that outlasts its time limit is killed whole, and
so is one whose rank failed, so a hang fails instead of waiting.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_ROOT = Path(__file__).resolve().parents[2]   # the directory holding the package
GRACE_S = 10.0   # the others' time to fail on their own after a rank failed


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _tail(f, limit: int = 4000) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")[-limit:]


def launch(command: Sequence[str], world: int, timeout: float,
           env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``command`` once per rank of a world of ``world`` and wait for
    every rank; returns each rank's standard output. Raises RuntimeError
    (each failed rank's exit code and the end of its standard error) once
    a rank fails, the others killed after GRACE_S seconds, and
    TimeoutError when the world outlasts ``timeout`` seconds (every rank
    killed). ``env`` adds to this process's environment."""
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world))
    outs, errs, procs = [], [], []
    try:
        for rank in range(world):
            outs.append(tempfile.TemporaryFile())
            errs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                list(command), stdout=outs[-1], stderr=errs[-1],
                stdin=subprocess.DEVNULL, start_new_session=True,
                env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank))))
        deadline = time.monotonic() + timeout
        failed_at = None
        while True:
            codes = [p.poll() for p in procs]   # every rank's, each round
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            if failed_at is None and any(codes):
                failed_at = now
            if now > deadline or (failed_at and now > failed_at + GRACE_S):
                break
            time.sleep(0.05)
        running = [r for r, p in enumerate(procs) if p.poll() is None]
        _kill(procs)
        bad = [r for r, p in enumerate(procs)
               if p.returncode and r not in running]
        if bad or running:
            report = "\n".join(
                f"--- rank {r} exit {procs[r].returncode}:\n{_tail(errs[r])}"
                for r in bad)
            if not bad:
                raise TimeoutError(
                    f"ranks {running} of {world} still running after "
                    f"{timeout:.0f} s; killed")
            raise RuntimeError(f"ranks {bad} of {world} failed"
                               + (f" (ranks {running} killed)" if running
                                  else "") + f"\n{report}")
        return [_tail(f, limit=1 << 30) for f in outs]
    finally:
        _kill(procs)
        for f in outs + errs:
            f.close()
