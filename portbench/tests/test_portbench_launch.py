"""The launch of a cell on several ranks, rehearsed on the CPU: a cell of
one card, at its tiny cut (``tests/tiny/``), started on two rank
processes over gloo (``repro_torch.launch.mesh.init_world``), each with
one shard of the collection in the port's mesh engine; rank 0 prints
the one result line. A cell is rehearsed at its own rank count, as many
as its ``chips``, by ``test_the_last_line_of_an_untraced_run``; this
test keeps a world of two whatever the cells ask for."""

import json

from portbench.bench.launch import spawn
from portbench.tests import tiny


def test_two_ranks_over_gloo_print_one_line(tmp_path):
    root = tiny.make_root(tmp_path)
    rc, line, err = spawn(root, dict(workload="search2m-solo.b256", seed=9,
                                     seconds=tiny.SECONDS, trace=False,
                                     t0=0.0), 2, "cpu", 240.0)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is True
    assert out["device"]["count"] == 2
    assert list(out)[-1] == "checks"
