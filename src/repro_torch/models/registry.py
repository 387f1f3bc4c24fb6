"""Family -> model function dispatch: the encoder-decoder family encdec
(``models/encdec.py``) and the decoder LM families dense, moe, ssm,
hybrid and vlm (``models/transformer.py``).

  api = model_api(cfg)
  params = api.init(seed, device)                  # ParamTree
  loss, metrics = api.loss(params.tree(), batch, remat="none",
                           ep_exchange=None)     # batch: tokens, labels
                                                 # [, vis_embed (vlm)]
                                                 # [, frames (encdec)]
  logits, cache = api.prefill(tree, batch, max_len)
  logits, cache = api.decode(tree, token, cache, position)
  cache = api.init_cache(tree, batch_size, max_len)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .config import ModelConfig
from . import encdec as E
from . import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def model_api(cfg: ModelConfig) -> ModelAPI:
    T._require_ported(cfg)
    if cfg.family == "encdec":
        return ModelAPI(
            cfg=cfg,
            init=lambda seed, device="cuda": E.init_encdec(seed, cfg, device),
            loss=lambda tree, batch, remat="none", ep_exchange=None:
                E.encdec_loss(tree, cfg, batch, remat=remat,
                              ep_exchange=ep_exchange),
            # a batch without ``frames`` raises KeyError, as the
            # reference's (the continuous batcher's prefill passes tokens)
            prefill=lambda tree, batch, max_len: E.encdec_prefill(
                tree, cfg, batch["frames"], batch["tokens"], max_len),
            decode=lambda tree, tok, cache, pos: E.encdec_decode(
                tree, cfg, tok, cache, pos),
            init_cache=lambda tree, b, s: E.init_encdec_cache(tree, cfg, b, s),
        )

    def _prefill(tree, batch, max_len):
        return T.lm_prefill(tree, cfg, batch["tokens"], max_len,
                            vis_embed=batch.get("vis_embed"))

    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device="cuda": T.init_lm(seed, cfg, device),
        loss=lambda tree, batch, remat="none", ep_exchange=None: T.lm_loss(
            tree, cfg, batch, remat=remat, ep_exchange=ep_exchange),
        prefill=_prefill,
        decode=lambda tree, tok, cache, pos: T.lm_decode(tree, cfg, tok, cache,
                                                         pos),
        init_cache=lambda tree, b, s: T.init_cache(tree, cfg, b, s),
    )
