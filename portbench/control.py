"""The readings a cell's limits are set from, on the card at the cell's
own size (the benchmark's runs never run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --queries 51200 [--program] [--faults half_probes,half_pool]

For each seed it makes the cell's collection and its stream of timed
queries as a run does, and prints one JSON line of readings
(``reference/judge.py``) for:

  control   the plain reference put in the program's place, in the
            precision below the configuration's (``knn(..., tf32=True)``:
            TF32 matmuls); it has to fail
  reference the plain reference itself (f32, TF32 off)
  program   with ``--program``: the system under test over the same
            batches, untimed (its readings on more seeds than the timed
            runs give)
  <fault>   for each of ``--faults``: the system under test over the
            same batches with that fault planted (``faults.py``)
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.bench import seeds
    from portbench.bench.spec import Spec
    from portbench.bench.world import World
    from portbench.frozen import randomwalk
    from portbench.frozen.queries import NoisyQueries, collection_std
    from portbench.reference.judge import NAMES, judge
    from portbench.reference.knn import knn

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    col = cfg["collection"]
    b, k = traffic["batch"], traffic["k"]
    runs = ((["program"] if args.program else [])
            + [f for f in args.faults.split(",") if f])
    unknown = [f for f in runs if f != "program" and f not in faults.FAULTS]
    if unknown:
        ap.error(f"no fault {unknown}; the faults: {sorted(faults.FAULTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        world = World("cuda")
        system = None
        if runs:
            system = spec.system(cfg["system"]).setup(cfg, traffic, seed,
                                                      world)
            x, scale = system.collection, system.scale
        else:
            x = randomwalk.generate(col["n_series"], col["series_len"],
                                    seeds.stream(seed, seeds.COLLECTION,
                                                 world.device))
            scale = collection_std(x)
        src = NoisyQueries(x, traffic["queries"]["levels"],
                           seeds.stream(seed, seeds.QUERIES, world.device),
                           scale)
        q = torch.cat([src.next(b) for _ in range(-(-args.queries // b))])
        answers = {}
        for run in runs:
            with (faults.planted(run) if run != "program"
                  else contextlib.nullcontext()):
                got = [system.query(q[i:i + b]) for i in range(0, len(q), b)]
            answers[run] = (torch.cat([a.ids.cpu() for a in got]),
                            torch.cat([a.dists.cpu() for a in got]))
            del got
        if system is not None:
            system.close()
            system = None
        line = {"seed": seed, "queries": int(q.shape[0])}
        ref_d, ref_i = knn(x, q, k)
        answers["reference"] = (ref_i, ref_d.clamp_min(0).sqrt())
        con_d, con_i = knn(x, q, k, tf32=True)
        answers["control"] = (con_i, con_d.clamp_min(0).sqrt())
        for run, (ids, dists) in answers.items():
            r = judge(x, q, ids, dists, ref_i)
            line[run] = {n: r[n] for n in NAMES}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del x, q, src, answers
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
