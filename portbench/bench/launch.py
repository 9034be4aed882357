"""A cell on several cards: one process a rank, each brought up by the
port's ``repro_torch.launch.mesh.init_world`` over a FileStore in a
temporary directory (NCCL on the card, gloo on the CPU).

Each rank runs the cell (``bench/rank.py``) with its output in files of
its own; rank 0 prints the result line. :func:`spawn` waits for every
rank, ends them all if one fails or the time runs out, and returns rank
0's exit code, its last line and its standard error.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from portbench.bench.spec import ROOT


def spawn(root: Path, args: dict, world: int, device: str,
          timeout: float) -> tuple:
    """(rank 0's exit code, its last line of output or None, the end of
    its standard error). ``args`` are the cell's run arguments
    (workload, seed, seconds, trace, t0); ``root`` holds the
    BENCHMARK.json the ranks read; the code runs from this checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp, \
            contextlib.ExitStack() as files:
        procs, logs = [], []
        for r in range(world):
            a = dict(args, rank=r, world=world, device=device, root=str(root),
                     store=os.path.join(tmp, "store"))
            out, err = (files.enter_context(
                open(os.path.join(tmp, f"rank{r}.{x}"), "w+"))
                for x in ("out", "err"))
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.bench.rank",
                 json.dumps(a)], cwd=ROOT, env=env, stdout=out, stderr=err))
        try:
            _wait_all(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out, err = logs[0]
        out.seek(0)
        err.seek(0)
        lines = [ln for ln in out.read().splitlines() if ln.strip()]
        tail = err.read()[-8000:]
        rc = procs[0].returncode
        if rc == 0:
            rc = next((p.returncode for p in procs if p.returncode), 0)
        return rc, (lines[-1] if lines else None), tail


def _wait_all(procs, timeout: float) -> None:
    """Until every rank has ended; the first to fail, or the deadline,
    ends the rest."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) \
                or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return
        time.sleep(0.05)
