"""Nested containers of tensors ("trees"): the LM surfaces keep their
parameters, optimizer moments and caches as the JAX package keeps its
pytrees, in dicts, lists, tuples and NamedTuples of tensors, so the two
packages' parameters line up name for name.

Flattening, mapping and rebuilding are ``torch.utils._pytree``'s; this
module adds the names. The name of a leaf is its path joined with ``/``
(``groups/0/attn/wq/w``): the checkpoint's keys and the names
:func:`repro_torch.convert.lm_params` reads. Dicts keep their insertion
order, so trees built from one another by :func:`tree_map` flatten in
the same order.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from torch.utils import _pytree

__all__ = ["named_leaves", "tree_leaves", "tree_map", "tree_unflatten"]

tree_leaves = _pytree.tree_leaves
tree_map = _pytree.tree_map


def _key_name(entry) -> str:
    # MappingKey.key, SequenceKey.idx, GetAttrKey.name (NamedTuple fields)
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"no name for the tree key {entry!r}")


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in flattening order."""
    return [("/".join(_key_name(e) for e in path), leaf)
            for path, leaf in _pytree.tree_flatten_with_path(tree)[0]]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure holding ``leaves`` (in flattening order)."""
    return _pytree.tree_unflatten(list(leaves),
                                  _pytree.tree_structure(template))
