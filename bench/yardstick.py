"""The benchmark's arithmetic: peaks of the card, model FLOPs, the wire
codec's geometry and bytes, a kernel's roofline share, percentiles.

Everything here follows from a configuration's shapes (through its
reference module) and the codec's configured geometry; nothing is read
from the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import refmodels

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def train_flops_per_token(cfg: Dict, seq_len: int) -> int:
    """Model FLOPs of one trained token (forward and backward, no
    recompute): 6 a weight the token meets in a product, plus the
    products between activations, both as the configuration's reference
    module counts them (``refmodels``)."""
    model = refmodels.for_config(cfg)
    return 6 * model.matmul_params_per_token(cfg) + model.attention_flops_per_token(cfg, seq_len)


def param_count(cfg: Dict) -> int:
    """Elements of the trained tree: the sum of the configuration's
    reference layout (the padded vocabulary, the norms' scales, the
    router; a tied head adds no leaf)."""
    return sum(math.prod(shape) for _, shape, _, _ in refmodels.for_config(cfg).layout(cfg))


def codec_geometry(n_elems: int, comp: Dict) -> Dict[str, int]:
    """The bucketed stream of ``n_elems`` gradient elements under the
    codec's configured geometry: G batches of ``lanes`` a block
    (``G = rows / ratio``), buckets of ``bucket_bytes`` rounded up to
    whole blocks and bitmap words, every bucket padded to whole blocks."""
    G = max(1, round(comp["rows"] / comp["ratio"]))
    block = G * comp["lanes"]
    quantum = math.lcm(block, 32)
    want = -(-max(1, comp["bucket_bytes"] // 4) // quantum) * quantum
    bucket = min(want, -(-n_elems // quantum) * quantum)
    n_buckets = -(-n_elems // bucket)
    return {"group": G, "block_elems": block, "bucket_elems": bucket,
            "n_buckets": n_buckets, "blocks": n_buckets * bucket // block}


def codec_bytes(blocks: int, comp: Dict) -> Dict[str, int]:
    """Least bytes of one launch of each fused wire kernel over ``blocks``
    blocks, each input read once and each output written once.
    Producer: the f32 stream and the block ids in; the sketch, the
    bitmap and the per-block max out. Consumer: the sketch, the bitmap
    and the block ids in; the f32 values and one residual byte an
    element out."""
    G = max(1, round(comp["rows"] / comp["ratio"]))
    c, R = comp["lanes"], comp["rows"]
    n_el = blocks * G * c
    sketch, bitmap, ids = blocks * R * c * 4, n_el // 8, blocks * 4
    return {"producer": n_el * 4 + ids + sketch + bitmap + blocks * 4,
            "consumer": sketch + bitmap + ids + n_el * 4 + n_el}


def least_ms(nbytes: float) -> float:
    """Time to move ``nbytes`` at the card's HBM rate, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def wire_bytes(blocks: int, comp: Dict) -> int:
    """Bytes one worker sends a step: each block's sketch (rows x lanes
    f32 cells) and its bitmap words."""
    G = max(1, round(comp["rows"] / comp["ratio"]))
    return blocks * (comp["rows"] * comp["lanes"] * 4 + G * comp["lanes"] // 8)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# launches of each fused wire kernel a step in one process, each over a
# share of the whole gradient's stream: the producer once for each of the
# process's workers, the consumer once
def launches_per_step(mix: Dict, side: str) -> int:
    return mix["workers"] // mix["ranks"] if side == "producer" else 1


def kernel_roofline_pct(run: Dict, kernel: str, side: str):
    """A fused wire kernel's least time over its device time in a run's
    profiled stretch: the least time that of the whole gradient's stream,
    times the launches a step over it (:func:`launches_per_step`) and the
    stretch's steps; the device time summed over every launch whose name
    holds ``kernel``, however the stream is cut into launches. None where
    the stretch holds no launch."""
    prof = run.get("profile")
    if not prof:
        return None
    times = [t for name, ts in prof["kernels"].items() if kernel in name for t in ts]
    if not times:
        return None
    mix = run["mix"]
    comp = mix["compression"]
    blocks = codec_geometry(param_count(run["cfg"]), comp)["blocks"]
    least = least_ms(codec_bytes(blocks, comp)[side]) * 1e-3 \
        * launches_per_step(mix, side) * prof["steps"]
    return 100.0 * least / sum(times)
