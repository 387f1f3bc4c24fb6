"""Architecture registry: ``get_arch(name) -> ArchSpec``, the
reference's ten archs; and the shape registry (``SHAPES``,
``make_batch_struct``)."""

from __future__ import annotations

import importlib

from .base import ArchSpec, ShapeConfig, SHAPES, make_batch_struct

_MODULES = {"qwen2-7b": "qwen2_7b",
            "qwen2.5-3b": "qwen2_5_3b",
            "qwen1.5-32b": "qwen1_5_32b",
            "granite-3-2b": "granite_3_2b",
            "mamba2-1.3b": "mamba2_1_3b",
            "internvl2-2b": "internvl2_2b",
            "jamba-v0.1-52b": "jamba_v0_1_52b",
            "deepseek-moe-16b": "deepseek_moe_16b",
            "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
            "whisper-tiny": "whisper_tiny"}


def list_archs():
    return sorted(_MODULES)


def get_arch(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {list_archs()}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}").ARCH


__all__ = ["ArchSpec", "ShapeConfig", "SHAPES", "get_arch", "list_archs",
           "make_batch_struct"]
