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
    if rest:
        def walk_rest(t, *rs):
            if is_leaf is not None and is_leaf(t):
                return fn(t, *rs)
            if isinstance(t, dict):
                return {k: walk_rest(v, *[r[k] for r in rs])
                        for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)([walk_rest(v, *[r[i] for r in rs])
                                for i, v in enumerate(t)])
            return fn(t, *rs)

        return walk_rest(tree, *rest)

    def walk(t):  # the one-tree case, kept lean: serving fills run it
        if is_leaf is not None and is_leaf(t):
            return fn(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)([walk(v) for v in t])
        return fn(t)

    return walk(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the same order ``tree_map`` visits them."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(tree)
    return leaves
