"""The fused int8 route with s8 queries on the card, at the benchmark's size.

A ``search_batch`` of 1,000 queries over 1,048,576 rows of dim 256
(1,000,000 live) runs one pipeline: the fold and the query quantization
once, 32 ``bmax_s8`` launches back to back (the last of 8 queries), one
select and one refine.  It must give each query what the small-Q body
gives the query's 32-row slice (ids equal, scores within 1e-6), and a
traced call must count its 32 stage-1 launches.

Card only, and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_search_card.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dewi_tpu_torch import DewiIndex
from dewi_tpu_torch.ops import cuda_search as cs
from dewi_tpu_torch.ops import similarity as tsim
from dewi_tpu_torch.utils import profiling as prof

N_DOCS, DIM, NQ = 1_000_000, 256, 1000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _index(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    emb = torch.randn((N_DOCS, DIM), generator=g, device=dev)
    pay = torch.rand((N_DOCS, 8), generator=g, device=dev)
    index = DewiIndex(dim=DIM, backend="int8", device=dev, rerank_eta=0.25,
                      entropy_pref=0.1, int8_queries=True)
    index._backend.store.attach_device([str(i) for i in range(N_DOCS)], emb, pay)
    index.build()
    assert index._backend.store.capacity == 1 << 20
    assert index._backend._fused_bmax_block()
    return index


@pytest.mark.cuda
def test_card_fused_batch_equals_its_32_query_slices(cuda_device):
    index = _index(cuda_device)
    q = torch.randn((NQ, DIM), generator=torch.Generator(device=cuda_device).manual_seed(4),
                    device=cuda_device)
    s, i = index.search_batch(q, k=10)
    # The slices get the normalised queries, which the 32-query groups of
    # the JAX package normalise once more.
    qn = tsim.l2_normalize(q)
    parts = [index.search_batch(qn[j:j + 32], k=10) for j in range(0, NQ, 32)]
    torch.cuda.synchronize()
    torch.testing.assert_close(s.cpu(), torch.cat([p[0] for p in parts]).cpu(),
                               rtol=0, atol=1e-6)
    assert torch.equal(i.cpu(), torch.cat([p[1] for p in parts]).cpu())

    prof.reset_trace_stats()
    before = cs.launch_counts["bmax_s8"]
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            index.search_batch(q, k=10)
        assert prof.trace_stats()["counters"] == {"search.stage1_groups": 32}
    finally:
        prof.reset_trace_stats()
    assert cs.launch_counts["bmax_s8"] - before == 32
