"""Worlds of subprocesses for the port's tests across ranks: rank and
reference subprocesses started together, each writing its log under the
test's directory, waited for under one deadline."""

import os
import subprocess
import sys
import time

import pytest


def start(jobs, out):
    """jobs: {name: ((code, arg), env)}; each runs ``python -c code arg
    out`` in ``out``. Returns ({name: Popen}, {name: log path})."""
    procs, logs = {}, {}
    for name, ((code, arg), env) in jobs.items():
        logs[name] = os.path.join(out, name + ".log")
        with open(logs[name], "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", code, arg, out], stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=out)
    return procs, logs


def stop(procs):
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def run_all(procs, logs, timeout):
    """Wait for every process; on the first failure or at ``timeout``
    seconds, kill them all and fail with that process's log."""
    end = time.monotonic() + timeout
    while True:
        codes = {name: p.poll() for name, p in procs.items()}
        bad = [n for n, c in codes.items() if c not in (None, 0)]
        late = time.monotonic() > end
        if bad or late:
            stop(procs)
            which = bad[0] if bad else next(
                n for n, c in codes.items() if c is None)
            with open(logs[which]) as f:
                tail = f.read()[-4000:]
            pytest.fail(f"{which} {'failed' if bad else 'timed out'}:\n"
                        f"{tail}")
        if all(c == 0 for c in codes.values()):
            return
        time.sleep(0.1)
