"""Parameter conversion between the reference and the port.

``params_from_jax`` takes the reference's params as a nested dict of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's :class:`~repro_torch.models.params.ParamTree`, leaf for leaf in
the reference's flatten order; ``params_to_numpy`` goes back. The tests
use the pair so both frameworks start from the same weights.

``cache_from_jax`` / ``cache_to_numpy`` carry a decode cache (the
reference's ``{"k", "v"}`` of numpy arrays) across the same way, so the
port's decode can continue from the reference's prefill.

bfloat16 arrays (numpy dtype name ``bfloat16``) move through their raw
16-bit patterns, so no bit changes. The ``*_to_numpy`` functions return
bfloat16 leaves as float32 (exact), since numpy has no bfloat16 of its
own.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.params import ParamTree, flatten_tree, unflatten_tree


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_tree: Dict, device="cuda") -> ParamTree:
    """Nested dict of numpy arrays -> ParamTree on ``device``."""
    return ParamTree(unflatten_tree(
        [(p, _to_torch(a, device)) for p, a in flatten_tree(np_tree)]))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_to_numpy(params: ParamTree) -> Dict:
    """ParamTree -> nested dict of numpy arrays (bfloat16 as float32)."""
    return unflatten_tree([(p, _to_numpy(t)) for p, t in
                           zip(params.paths, params.leaves())])


def cache_from_jax(np_cache: Dict, device="cuda") -> Dict:
    """The reference's decode cache as numpy arrays -> the same nested
    dict of tensors on ``device``."""
    return unflatten_tree(
        [(p, _to_torch(a, device)) for p, a in flatten_tree(np_cache)])


def cache_to_numpy(cache: Dict) -> Dict:
    """A decode cache of tensors -> numpy arrays (bfloat16 as float32)."""
    return unflatten_tree([(p, _to_numpy(t)) for p, t in flatten_tree(cache)])
