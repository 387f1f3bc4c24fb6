"""Family -> model function dispatch (the dense and moe families).

  api = model_api(cfg)
  params = api.init(seed, device)                  # ParamTree
  loss, metrics = api.loss(params.tree(), batch, remat="none",
                           ep_exchange=None)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .config import ModelConfig
from . import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    loss: Callable


def model_api(cfg: ModelConfig) -> ModelAPI:
    T._require_ported(cfg)
    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device="cuda": T.init_lm(seed, cfg, device),
        loss=lambda tree, batch, remat="none", ep_exchange=None: T.lm_loss(
            tree, cfg, batch, remat=remat, ep_exchange=ep_exchange),
    )
