"""The benchmark's arithmetic against hand arithmetic: model FLOPs a
token, parameters, the codec's geometry, bytes and bounds, the wire
bytes, a kernel's roofline share."""

import json
import math
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import refmodels  # noqa: E402
import yardstick as ys  # noqa: E402

GRANITE = json.loads((HERE / "configs" / "granite-3-2b.d4.json").read_text())
DEEPSEEK = json.loads((HERE / "configs" / "deepseek-moe-16b.d1.json").read_text())
COMP = json.loads((HERE / "mixes" / "train.w2.json").read_text())["compression"]


def test_granite_flops_per_token():
    attn = 2048 * 2048 + 2 * 2048 * 8 * 64 + 2048 * 2048     # wq, wk, wv, wo
    mlp = 3 * 2048 * 8192
    matmul = 4 * (attn + mlp) + 2048 * 49155                 # + the (tied) head
    scores = 6 * 1024 * 32 * 64 * 4                          # causal, fwd + bwd
    assert ys.train_flops_per_token(GRANITE, 1024) == 6 * matmul + scores
    assert ys.train_flops_per_token(GRANITE, 1024) == 2_113_966_080


def test_deepseek_flops_per_token():
    attn = 4 * 2048 * 2048
    experts = 6 * 3 * 2048 * 1408 + 2 * 3 * 2048 * 1408 + 2048 * 64
    matmul = attn + experts + 2048 * 102400
    scores = 6 * 1024 * 16 * 128 * 1
    assert ys.train_flops_per_token(DEEPSEEK, 1024) == 6 * matmul + scores
    assert ys.train_flops_per_token(DEEPSEEK, 1024) == 1_787_559_936


@pytest.mark.parametrize("cfg", [GRANITE, DEEPSEEK], ids=["granite", "deepseek"])
def test_param_count_is_the_configs(cfg):
    assert ys.param_count(cfg) == cfg["params"]


def _decoder_param_count(cfg):
    """The count's closed form before the reference's layout gave it."""
    D, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 2 * D
    moe = cfg.get("moe")
    if moe:
        f = moe["expert_d_ff"]
        layer += D * moe["num_experts"] + (moe["num_experts"] + moe["shared_experts"]) * 3 * D * f
    else:
        layer += 3 * D * cfg["d_ff"]
    tables = 1 if cfg.get("tie_embeddings") else 2
    return cfg["n_layers"] * layer + tables * (-(-cfg["vocab"] // 128) * 128) * D + D


@pytest.mark.parametrize("cfg", [GRANITE, DEEPSEEK, dict(GRANITE, tie_embeddings=False)],
                         ids=["granite", "deepseek", "granite-untied"])
def test_param_count_is_the_layouts_sum(cfg):
    lay = refmodels.for_config(cfg).layout(cfg)
    assert ys.param_count(cfg) == sum(math.prod(s) for _, s, _, _ in lay) \
        == _decoder_param_count(cfg)


def test_param_counts_by_hand():
    D, Vp = 2048, 49280                                      # 49,155 padded to 128s
    layer = 2 * D * D + 2 * D * 8 * 64 + 3 * D * 8192 + 2 * D
    assert ys.param_count(GRANITE) == 4 * layer + Vp * D + D == 344_213_504
    untied = dict(GRANITE, tie_embeddings=False)
    assert ys.param_count(untied) == 344_213_504 + Vp * D    # + an lm_head
    moe = 4 * D * D + 2 * D + D * 64 + (64 + 2) * 3 * D * 1408
    assert ys.param_count(DEEPSEEK) == moe + 2 * 102400 * D + D == 1_007_294_464


def test_codec_bounds_at_14525_blocks():
    """The codec's bytes for 14,525 blocks (G 60, c 512, rows 6) at
    3.35 TB/s: the producer's and the consumer's least times."""
    b = ys.codec_bytes(14525, COMP)
    assert round(ys.least_ms(b["producer"]), 3) == 0.603
    assert round(ys.least_ms(b["consumer"]), 3) == 0.736


def test_granite_geometry_and_wire_bytes():
    g = ys.codec_geometry(ys.param_count(GRANITE), COMP)
    assert g == {"group": 60, "block_elems": 30720, "bucket_elems": 35 * 30720,
                 "n_buckets": 321, "blocks": 11235}
    # the sketch is 138.1 MB and the bitmap 43.1 MB: ~13% of the dense f32
    assert ys.wire_bytes(11235, COMP) == 11235 * (6 * 512 * 4 + 60 * 512 // 8)
    assert ys.wire_bytes(11235, COMP) == 181_198_080


def test_deepseek_geometry():
    g = ys.codec_geometry(ys.param_count(DEEPSEEK), COMP)
    assert g["n_buckets"] == -(-1_007_294_464 // (35 * 30720))
    assert g["blocks"] == g["n_buckets"] * 35


@pytest.mark.parametrize("chunks", [1, 7])
def test_roofline_share_is_the_same_however_the_stream_is_cut(chunks):
    """Two traced steps of W 2: each producer launch's time split over
    ``chunks`` launches reads the same share."""
    comp = COMP
    blocks = ys.codec_geometry(ys.param_count(GRANITE), comp)["blocks"]
    least = ys.least_ms(ys.codec_bytes(blocks, comp)["producer"]) * 1e-3
    launches = [2 * least / chunks] * (2 * 2 * chunks)      # each at 50%
    run = {"cfg": GRANITE, "mix": {"workers": 2, "ranks": 1, "compression": comp},
           "profile": {"steps": 2, "kernels": {"wire_encode_kernel<float>": launches}}}
    assert ys.kernel_roofline_pct(run, "wire_encode_kernel", "producer") == pytest.approx(50.0)
    assert ys.kernel_roofline_pct(run, "wire_peel_kernel", "consumer") is None


def test_percentile():
    assert ys.percentile(list(range(101)), 90) == 90.0
    assert ys.percentile([1.0, 2.0], 50) == 1.5
