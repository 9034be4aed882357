"""repro_torch on the card: each CUDA kernel against its plain version,
and the entry points' default device. Needs a CUDA device (skips
elsewhere) but not jax, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.core import search
from repro_torch.core.indexes import dstree, isax, vafile
from repro_torch.data import queries, randomwalk
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["paa", "box_mindist", "l2",
                                  "coop_score_select"])
def test_kernel_matches_plain_version_on_card(cuda, name):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(300, 96, generator=g, device=cuda)
    before = getattr(ops, name).launches
    if name == "paa":
        torch.testing.assert_close(ops.paa(x, 8), ref.ref_paa(x, 8),
                                   atol=0, rtol=0)
    elif name == "box_mindist":
        q, lo = x[:7, :16].contiguous(), x[7:, :16] - 1.0
        hi, w = lo + x[7:, 16:32].abs(), x[0, :16].abs() + 0.5
        lo, hi = lo.contiguous(), hi.contiguous()
        torch.testing.assert_close(ops.box_mindist(q, lo, hi, w),
                                   ref.ref_box_mindist(q, lo, hi, w), **TOL)
    elif name == "l2":
        torch.testing.assert_close(ops.l2(x[:9], x), ref.ref_l2(x[:9], x),
                                   **TOL)
    else:
        ids = torch.arange(300, dtype=torch.int32, device=cuda)
        args = (x[:9].contiguous(), x, ops.row_sq_norms(x), ids, 40)
        got, want = ops.coop_score_select(*args), \
            ref.ref_coop_score_select(*args)
        torch.testing.assert_close(got[0], want[0], **TOL)
    assert getattr(ops, name).launches == before + 1


@pytest.mark.parametrize("builder,visit_batch", [(isax.build, 1),
                                                 (dstree.build, 1),
                                                 (vafile.build, 16)])
def test_entry_points_run_on_the_card_by_default(cuda, builder,
                                                 visit_batch):
    data = randomwalk.generate(seed=5, n_series=2048, series_len=64)
    q = queries.noisy_queries(data, 8)
    truth = search.brute_force(q, data, 10)
    index = builder(data, **({} if builder is vafile.build
                             else {"leaf_cap": 64}))
    res = search.search(index, q, 10, visit_batch=visit_batch)
    assert res.ids.is_cuda and index.data.is_cuda
    assert torch.equal(res.ids, truth.ids)
