"""repro_torch package hygiene: it imports neither jax nor the JAX
package (repro), and every kernel has a CUDA source exporting the
functions its binding declares, a wrapper and a launch counter."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_the_walk_covers_the_launch_tooling():
    walked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("analytic", "roofline", "dryrun", "dryrun_search"):
        assert f"src/repro_torch/launch/{name}.py" in walked, name


def test_every_kernel_source_exports_its_bound_functions():
    from repro_torch.kernels import build

    assert set(build.SIGNATURES) == set(build.SOURCES)
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        exported = set(re.findall(r'extern "C" int (\w+)\(', src))
        assert exported == set(fns), name


def test_every_kernel_wrapper_counts_launches():
    from repro_torch.kernels import ops

    for fn in (ops.paa, ops.box_mindist, ops.l2, ops.coop_score_select,
               ops.pq_adc_batch, ops.pq_adc_select):
        assert isinstance(fn.launches, int)
