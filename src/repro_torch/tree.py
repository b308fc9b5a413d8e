"""Parameter trees: nested dicts / lists / tuples with tensor leaves.

The port keeps the JAX package's tree structure and key names (``stem``,
``stem_gn``, ``blocks[i].conv1``, ``head_w`` …), so a JAX pytree carried
across as numpy arrays maps one-to-one onto a port tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply ``fn`` to every leaf (with the matching leaves of ``rest``).

    The walkers are module-level functions: a recursive closure would be a
    reference cycle (function -> cell -> function) holding ``fn`` and all
    it captures until the garbage collector runs — on the card, device
    memory the caller has already let go."""
    if rest:
        return _walk_rest(tree, rest, fn, is_leaf)
    return _walk(tree, fn, is_leaf)


def _walk(t, fn, is_leaf):  # the one-tree case, kept lean: fills run it
    if is_leaf is not None and is_leaf(t):
        return fn(t)
    if isinstance(t, dict):
        return {k: _walk(v, fn, is_leaf) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)([_walk(v, fn, is_leaf) for v in t])
    return fn(t)


def _walk_rest(t, rs, fn, is_leaf):
    if is_leaf is not None and is_leaf(t):
        return fn(t, *rs)
    if isinstance(t, dict):
        return {k: _walk_rest(v, [r[k] for r in rs], fn, is_leaf)
                for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)([_walk_rest(v, [r[i] for r in rs], fn, is_leaf)
                        for i, v in enumerate(t)])
    return fn(t, *rs)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the same order ``tree_map`` visits them."""
    leaves: List[Any] = []
    _collect(tree, leaves)
    return leaves


def _collect(t, leaves: List[Any]) -> None:
    if isinstance(t, dict):
        for v in t.values():
            _collect(v, leaves)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _collect(v, leaves)
    else:
        leaves.append(t)
