"""Parameter trees: nested dicts / lists / tuples with tensor leaves.

The port keeps the JAX package's tree structure and key names (``stem``,
``stem_gn``, ``blocks[i].conv1``, ``head_w`` …), so a JAX pytree carried
across as numpy arrays maps one-to-one onto a port tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply ``fn`` to every leaf (with the matching leaves of ``rest``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the same order ``tree_map`` visits them."""
    leaves: List[Any] = []
    tree_map(leaves.append, tree)
    return leaves
