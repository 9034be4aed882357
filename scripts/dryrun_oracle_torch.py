"""The reference's two dry-run oracle cells on the PyTorch port, uncut.

``tests/test_distributed.py`` holds the reference's dry run to two cells
on 8 host devices: jamba-v0.1-52b's smoke config, ``train_4k`` with
grad_accum 2 and dense attention up to 8192 on (2, 2, 2) ("pod", "data",
"model"), and gemma2-2b's smoke config, ``decode_32k`` on (4, 2)
("data", "model"). ``tests/test_torch_dryrun_mesh.py`` runs the port's
``lower_cell`` on them with the train cell's sequence cut for time; this
runs both at their full shapes on dry worlds (torch's fake backend, this
process rank 0) and writes each report under ``OUT/oracle/``, printing
its status, collectives, live bytes and host seconds.

    PYTHONPATH=src python scripts/dryrun_oracle_torch.py [--out build/dryrun]
"""

import argparse
import json
import os
from unittest import mock

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

CELLS = [
    ("jamba-v0.1-52b", "train_4k", (2, 2, 2), ("pod", "data", "model"),
     dict(grad_accum=2, arch_overrides={"attn_dense_threshold": 8192})),
    ("gemma2-2b", "decode_32k", (4, 2), ("data", "model"), {}),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    out = os.path.join(ap.parse_args().out, "oracle")
    os.makedirs(out, exist_ok=True)
    with mock.patch.object(dryrun, "get_config", configs.get_smoke_config):
        for arch, shape, dims, axes, kw in CELLS:
            mesh = mesh_mod.init_dry_world(dims, axes)
            try:
                rep = dryrun.lower_cell(arch, shape, mesh, **kw)
            finally:
                mesh_mod.destroy_world()
            with open(os.path.join(out, f"{arch}__{shape}.json"), "w") as f:
                json.dump(rep, f, indent=2, default=str)
            m = rep["memory_analysis"]
            print(f"{arch} {shape} on {dims}: {rep['status']}, "
                  f"{rep['n_collectives']} collectives "
                  f"{rep['wire_bytes_by_kind']}, bottleneck "
                  f"{rep['bottleneck']}, live "
                  f"{m['live_bytes'] / 2 ** 30:.1f} GiB a device, "
                  f"{rep['lower_seconds']} s", flush=True)


if __name__ == "__main__":
    main()
