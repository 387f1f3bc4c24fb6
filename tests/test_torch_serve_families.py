"""Serving on the (data x model) rank grid for the ssm, hybrid, vlm and
encdec families against the reference's sharded serve steps, by the
machinery of ``tests/test_torch_serve_steps.py``: one reference
subprocess with 4 fake CPU devices for every case, one spawn of 4 gloo
ranks on a (data 2, model 2) grid.

The smoke configs of mamba2-1.3b (ssm: the Mamba2 mixer on its head
shard, its ``ssm`` state this rank's heads, its ``conv`` state whole),
jamba-v0.1-52b (hybrid: Mamba and attention in one superblock, MoE on
the odd positions; its states carry the ``(n_super, attn_period - 1)``
lead), internvl2-2b (vlm: the cache holds the visual prefix's positions
too) and whisper-tiny (encdec: the encoder tensor-parallel, the cross
K/V whole on every model rank, the decoder's self cache sequence-split),
at B 4 and B 1, prompts of 8 and 4 greedy decode steps:

- the greedy tokens equal;
- the logits at ``rtol=1e-5, atol=1e-6``;
- each rank's cache after the prefill and after the last step equal to
  its ``shard_leaf`` block of the reference's whole cache;
- the spec trees equal the reference's;
- the Mamba ``conv`` state the same bytes on the two model ranks of a
  data index (their rows, at B 4) or on all four (B 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_serve_steps import (check_caches, check_logits, check_specs,
                                    check_tokens, run_grid)

CASES = {f"{short}_b{B}": (arch, B, 2, {})
         for short, arch in (("mamba", "mamba2-1.3b"),
                             ("jamba", "jamba-v0.1-52b"),
                             ("internvl", "internvl2-2b"),
                             ("whisper", "whisper-tiny"))
         for B in (4, 1)}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_grid(str(tmp_path_factory.mktemp("serve_families")), CASES,
                    False)


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal_reference(grid, name):
    check_tokens(grid, name)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_reference_sharded_steps(grid, name):
    check_logits(grid, name, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_match_reference_cache_pspecs(grid, name):
    check_caches(grid, name, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_shardings_spec_trees_equal_reference(grid, name):
    check_specs(grid, name, CASES)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith(("mamba", "jamba"))])
def test_conv_state_is_the_same_bytes_on_every_model_rank(grid, name):
    ranks = grid["ranks"]
    B = CASES[name][1]
    for which in ("cache0", "cache"):
        convs = [{p: c for p, c in r[name][which].items()
                  if p.endswith("conv")} for r in ranks]
        assert convs[0]
        # the two model ranks of each data index; at B 1 every rank holds
        # the same rows
        pairs = [(0, 1), (2, 3)] + ([(0, 2)] if B == 1 else [])
        for a, b in pairs:
            for p in convs[a]:
                np.testing.assert_array_equal(convs[a][p], convs[b][p])
        # and each model rank's ssm state is its own heads
        ssm = [{p: c for p, c in r[name][which].items() if p.endswith("ssm")}
               for r in ranks]
        for p in ssm[0]:
            assert not np.array_equal(ssm[0][p], ssm[1][p])
