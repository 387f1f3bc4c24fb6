"""Architecture registry: ``get_arch(name) -> ArchSpec``."""

from __future__ import annotations

import importlib

from .base import ArchSpec

_MODULES = {"granite-3-2b": "granite_3_2b"}


def list_archs():
    return sorted(_MODULES)


def get_arch(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {list_archs()}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}").ARCH
