"""PyTorch port vs the JAX reference: how much of the aggregate the peel
recovers at the main path's compression.

The W=2 JAX reference is the composed aggregate of
``test_torch_aggregate.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CompressionConfig as JaxConfig
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.collectives import AggregationState, LocalWorkers
from test_torch_aggregate import jax_compressed_aggregate, tcfg


def test_recovery_at_the_main_path_compression_matches_reference():
    """The main path's compression (ratio 0.1, rows 6, 512 lanes, top-k 4%
    per worker with error feedback, W=2) on Gaussian gradients, one step,
    on a 500,992-element stream (17 blocks). The peel's choices depend on
    the integer degrees only, so the reference and the port report the
    same ``RecoveryStats`` to the coordinate, whatever the float rounding.
    Pinned: the union of the two workers' top-k indexes 39,785
    coordinates (7.9% of the stream), near the sketch's peeling capacity
    (3072 cells / 1.23 per 30,720-element block, 8.1%), and a third of
    them (13,138) fall back to the median estimate."""
    jc = JaxConfig(ratio=0.1, topk_ratio=0.04)
    shapes = [(512, 384), (384, 512), (1280,), (256, 256), (40, 1024)]
    rng = np.random.default_rng(11)
    W = 2
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(W)]
    res_j = [[np.zeros(s, np.float32) for s in shapes] for _ in range(W)]
    _, _, want = jax_compressed_aggregate(grads, res_j, jc, with_stats=True)
    _, st = make_aggregator("compressed", tcfg(jc), LocalWorkers(W))(
        [[torch.from_numpy(g) for g in gw] for gw in grads],
        AggregationState(residual=[torch.zeros((W,) + s) for s in shapes]))
    got = (int(st.stats.nnz), int(st.stats.peeled), int(st.stats.residual))
    assert got == (int(want.nnz), int(want.peeled), int(want.residual))
    assert got == (39_785, 26_647, 13_138)
