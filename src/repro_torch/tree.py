"""Trees of tensors: nested dicts, lists and dataclasses (the port's
parameter, optimizer and train-state trees), walked in the JAX
package's pytree order -- dict keys sorted, list items in order,
dataclass fields in declaration order, ``None`` an empty subtree -- so
sums over leaves round alike and checkpoint paths match
``jax.tree_util.tree_flatten_with_path``'s."""

from __future__ import annotations

import dataclasses


def _children(tree):
    """``[(key, child), ...]`` of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure; returns a tree of the same structure."""
    if tree is None:
        return None
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(tree, *rest)

    def sub(key):
        return tree_map(fn, _get(tree, key),
                        *(_get(r, key) for r in rest), is_leaf=is_leaf)

    done = {k: sub(k) for k, _ in kids}        # fn runs in pytree order
    if isinstance(tree, dict):
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(done[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **{k[1:]: v for k, v in done.items()})


def _get(tree, key):
    if isinstance(key, str) and key.startswith(".") \
            and dataclasses.is_dataclass(tree):
        return getattr(tree, key[1:])
    return tree[key]


def tree_paths(tree, prefix: str = ""):
    """``[(path, leaf), ...]`` in pytree order; a path joins the keys
    with ``/`` as the JAX package's checkpoint names its leaves."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += tree_paths(child, f"{prefix}/{key}" if prefix else str(key))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in pytree
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
