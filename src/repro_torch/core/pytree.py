"""A small pytree helper over nested dicts, lists and tuples.

The port keeps its parameters, KV pools and snapshot payloads as plain
nested containers of tensors and arrays. Two things about them must match
the JAX package exactly, because snapshot chains cross between the two:

* **flatten order** — dict keys are visited in sorted order, list/tuple
  items in index order, and ``None`` is an empty subtree (no leaf), as
  ``jax.tree_util.tree_flatten`` does;
* **leaf keys** — :func:`keystr` renders a path as
  ``jax.tree_util.keystr`` does: ``['pool']['kv']['k']`` for dict keys,
  ``[0]`` for sequence indices.

Everything that is not a dict, list, tuple or ``None`` is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

PyTree = Any

_Path = tuple  # tuple of dict keys / sequence indices


def _children(node: Any) -> Iterator[tuple[Any, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield k, node[k]
    else:
        yield from enumerate(node)


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def keystr(path: _Path) -> str:
    """``jax.tree_util.keystr`` of a path: ``['a'][0]['b']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def flatten_with_path(tree: PyTree,
                      is_leaf: Callable[[Any], bool] | None = None
                      ) -> list[tuple[_Path, Any]]:
    """``(path, leaf)`` pairs in JAX flatten order; ``is_leaf`` stops the
    walk at matching containers (e.g. a ``Compressed`` named tuple)."""
    out: list[tuple[_Path, Any]] = []

    def walk(node: Any, path: _Path) -> None:
        if node is None:
            return
        if _is_node(node) and not (is_leaf is not None and is_leaf(node)):
            for k, child in _children(node):
                walk(child, path + (k,))
            return
        out.append((path, node))

    walk(tree, ())
    return out


def leaves(tree: PyTree) -> list[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over trees of one structure (containers keep
    their type; dicts keep their key order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        # a named tuple takes its fields positionally
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(tree, *rest)


def unflatten_like(template: PyTree, by_key: dict[str, Any],
                   what: str = "tree") -> PyTree:
    """Rebuild ``template``'s structure with the leaves ``by_key`` names
    (keys as :func:`keystr` renders them); a template leaf missing from
    ``by_key`` raises ``KeyError`` naming it."""
    def build(node: Any, path: _Path) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        key = keystr(path)
        if key not in by_key:
            raise KeyError(f"template leaf {key} not in {what}")
        return by_key[key]

    return build(template, ())
