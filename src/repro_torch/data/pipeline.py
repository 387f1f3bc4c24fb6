"""Deterministic synthetic data pipeline.

Every batch is a pure numpy function of ``(seed, step)``, the
reference's own construction, so the port and the reference train on the
same tokens.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_fn(cfg: ModelConfig, global_batch: int, seq_len: int,
             seed: int = 0) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns step -> host batch dict (tokens, labels: int32 (B, S))."""

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, 0xDA7A]))
        toks = rng.integers(0, cfg.vocab, (global_batch, seq_len + 1),
                            dtype=np.int32)
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make
