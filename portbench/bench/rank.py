"""One rank of a cell on several cards (``bench/launch.py`` starts it):
``python -m portbench.bench.rank '<json arguments>'``. Rank 0 prints the
result line."""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main(argv) -> int:
    a = json.loads(argv[0])
    import torch.distributed as dist
    from repro_torch.launch.mesh import destroy_world, init_world

    from portbench.bench.harness import forbidden_modules, run_cell
    from portbench.bench.spec import Spec
    from portbench.bench.world import World

    store = dist.FileStore(a["store"], a["world"])
    dev = init_world(a["device"], store=store, rank=a["rank"],
                     world_size=a["world"])
    try:
        out = run_cell(Spec(Path(a["root"])), a["workload"], a["seed"],
                       a["seconds"], a["trace"], t0=a["t0"], device=dev,
                       world=World(dev, a["rank"], a["world"]))
    finally:
        destroy_world()
    if out is not None:
        bad = forbidden_modules()
        if bad:
            print(f"portbench: loaded {bad}", file=sys.stderr)
            return 3
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
