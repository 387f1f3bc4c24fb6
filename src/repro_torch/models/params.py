"""Parameters as named tensors in the reference's leaf order.

The compressed wire packs gradient leaves into one stream in the order
``jax.tree.flatten`` gives the reference's params dict (keys sorted at
every level, ``layers`` one stacked subtree), and the hash block ids
follow from stream position. :class:`ParamTree` keeps that order
explicitly: its ``nn.Parameter``s are registered under the reference's
paths (``layers/attn/wq`` as ``layers__attn__wq``), and :meth:`leaves`
returns them sorted by path, which is the flatten order. It never relies
on ``named_parameters()`` registration order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn


def flatten_tree(tree: Dict, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], object]]:
    """Nested dict -> [(path, leaf)] sorted as ``jax.tree.flatten``."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flatten_tree(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def unflatten_tree(items: Sequence[Tuple[Tuple[str, ...], object]]) -> Dict:
    """[(path, leaf)] -> nested dict."""
    root: Dict = {}
    for path, v in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return root


class ParamTree(nn.Module):
    """A params pytree of the reference as an ``nn.Module``."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        items = flatten_tree(tree)
        self.paths: Tuple[Tuple[str, ...], ...] = tuple(p for p, _ in items)
        for path, t in items:
            self.register_parameter("__".join(path), nn.Parameter(
                torch.as_tensor(t), requires_grad=True))

    def leaves(self) -> List[nn.Parameter]:
        """Parameters in ``jax.tree.flatten`` order."""
        return [getattr(self, "__".join(p)) for p in self.paths]

    def tree(self) -> Dict:
        """The nested dict of parameters the functional model code takes."""
        return unflatten_tree(list(zip(self.paths, self.leaves())))
