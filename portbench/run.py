"""Run one cell of BENCHMARK.json once, on the card, and print one JSON
line as the last line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Refuses (exit 2, no result) without as many CUDA cards as the cell
asks for, and (exit 3) when JAX or the JAX package is loaded once the
window has closed. The compared numbers are printed, each beside its
limit, as the last lines of standard error and last in the result line.
"""

import time

T0 = time.perf_counter()  # setup_s counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

RANK_TIMEOUT = 330.0  # seconds a rank of a several-card cell may run


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.bench.spec import Spec

    spec = Spec(ROOT)
    chips = spec.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {have}; nothing measured", file=sys.stderr)
        return 2
    print(f"portbench: card {card_line()}, torch {torch.__version__}",
          file=sys.stderr, flush=True)
    from portbench.bench.harness import forbidden_modules, run_cell

    if chips == 1:
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=T0)
    else:
        from portbench.bench.launch import spawn

        rc, line, err = spawn(ROOT, dict(
            workload=args.workload, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), t0=T0), chips, "cuda", RANK_TIMEOUT)
        sys.stderr.write(err)
        if rc != 0 or line is None:
            print(f"portbench: rank 0 ended with {rc}", file=sys.stderr)
            return rc or 1
        result = json.loads(line)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
