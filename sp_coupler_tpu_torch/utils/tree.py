"""Leaves of nested state in ``jax.tree.flatten`` order.

Dict keys sorted, NamedTuple fields in order, None an empty subtree: the
order the JAX package flattens its pytrees in, so that a packed diag
vector or a checkpoint's numbered leaves mean the same in both packages.
"""


def flatten(tree):
    """(leaves, spec) of a tree of dicts, NamedTuples and leaves."""
    if tree is None:
        return [], ("none", None, [])
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        return ([l for p in parts for l in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [flatten(x) for x in tree]
        return ([l for p in parts for l in p[0]],
                ("namedtuple", type(tree), [p[1] for p in parts]))
    return [tree], None


def unflatten(spec, leaves):
    """Inverse of flatten: the tree of spec with the leaves of the iterator
    ``leaves`` in order."""
    if spec is None:
        return next(leaves)
    kind, meta, children = spec
    if kind == "none":
        return None
    vals = [unflatten(ch, leaves) for ch in children]
    if kind == "dict":
        return dict(zip(meta, vals))
    return meta(*vals)
