"""A run of a cell (tiny, on the CPU) in a subprocess loads neither JAX
nor the JAX package, compared by whole top-level module names
(``repro_torch`` is the port and passes), and opens no file under
``benchmarks/``."""

import json
import os
import subprocess
import sys

from portbench.bench.harness import FORBIDDEN
from portbench.bench.spec import ROOT
from portbench.tests import tiny

SCRIPT = r"""
import json, sys, time
opened = []
sys.addaudithook(lambda ev, a: opened.append(str(a[0]))
                 if ev == "open" and isinstance(a[0], str) else None)
from pathlib import Path
import portbench.control, portbench.bench.launch, portbench.bench.rank
from portbench.bench.harness import run_cell
from portbench.bench.spec import Spec
root = Path(sys.argv[1])
spec = Spec(root)
for w in spec.bench["workloads"]:
    run_cell(spec, w["name"], 5, 0.1, False, t0=time.perf_counter(),
             device="cpu")
for p in sorted((root / "portbench").rglob("*.py")):
    if "tests" not in p.parts:
        __import__("portbench.bench.spec").bench.spec.plugin(p) \
            if p.parent.name in ("metrics", "systems", "generators") else None
print(json.dumps({"modules": sorted(sys.modules), "opened": opened}))
"""


def test_a_run_loads_no_jax_and_reads_nothing_of_benchmarks(tmp_path):
    root = tiny.make_root(tmp_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(root)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in got["modules"]}
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    bench_dir = os.path.join(str(ROOT), "benchmarks") + os.sep
    assert not [p for p in got["opened"]
                if os.path.abspath(p).startswith(bench_dir)]
    assert any(p.endswith("BENCHMARK.json") for p in got["opened"])
