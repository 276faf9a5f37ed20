"""Sharding rules for the model families, and the shards they give a rank.

Counterpart of ``audiotoken_tpu/parallel/shard.py``: the same Megatron
rules, as functions over the port's flat-store names (``layers/0#/attn/
qkv/kernel``, ``convert/store.py``) of a JAX-layout tree (linear kernels
[in, out]). Column-parallel qkv and mlp-in kernels (output dim on "tp"),
row-parallel attention-out and mlp-out kernels (input dim on "tp"),
vocab-parallel embeddings; LayerNorms and position tables replicated.

A spec leaf is a :class:`P`, one mesh axis name (or None) per dim, as
JAX's ``PartitionSpec``. Where JAX hands XLA a sharding and XLA chooses
how to compute under it, a rank here computes on its own shard
(:func:`shard_tree`), so a shard must be a piece of the same function.
That is why ``P`` has ``groups``: the fused GPT qkv kernel [C, 3C] is q, k
and v side by side, and rank r must hold heads ``r*H/tp ... (r+1)*H/tp``
of each of the three, not the r-th contiguous block of 3C columns
(``groups=3``); the conformer's ``pw1`` [H, 2H] is followed by a GLU that
pairs channel i with channel i + H, so rank r holds both halves for its
channels (``groups=2``).
"""

from typing import Any, Dict, List, Mapping

import numpy as np


class P(tuple):
    """A partition spec: one mesh axis name or None per dim of a leaf.
    ``groups``: the sharded dim is that many equal blocks side by side, each
    split over the axis alike."""

    def __new__(cls, *axes, groups: int = 1):
        self = super().__new__(cls, axes)
        self.groups = groups
        return self

    def __repr__(self):
        g = f", groups={self.groups}" if self.groups != 1 else ""
        return f"P({', '.join(map(repr, self))}{g})"


def _map_named(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(name, leaf)`` over a tree of dicts and lists, with store names;
    None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [_map_named(fn, v, f"{prefix}{i}#/") for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix[:-1], tree)


def _replicated(leaf) -> P:
    return P(*([None] * np.ndim(leaf)))


def _gpt_leaf_spec(name: str):
    """The Megatron rule for one GPT leaf (None = replicate)."""
    if "wte" in name:
        return P("tp", None)  # vocab-parallel embedding
    if "wpe" in name:
        return P(None, None)
    if "attn/qkv/kernel" in name:
        return P(None, "tp", groups=3)  # column parallel, head-wise in q, k and v
    if "attn/qkv/bias" in name:
        return P("tp", groups=3)
    if "mlp/in/kernel" in name:
        return P(None, "tp")
    if "mlp/in/bias" in name:
        return P("tp")
    if "attn/out/kernel" in name or "mlp/out/kernel" in name:
        return P("tp", None)  # row parallel
    return None


def gpt_param_spec(params: Any) -> Any:
    """Spec tree matching a JAX-layout GPT tree (``nn/gpt.py:init_gpt_params``)."""
    return _map_named(lambda n, leaf: _gpt_leaf_spec(n) or _replicated(leaf), params)


def gpt_sampler_param_spec(params: Any) -> Any:
    """Spec tree for a sampler's GPT tree: :func:`gpt_param_spec`'s rules.
    The JAX sampler stacks its layers under ``layers_stacked`` with a
    leading [L] axis, which replicates; a stacked leaf's spec is the
    per-layer spec with a None in front. The port's sampler keeps the
    layers as a list, whose names take the rules unchanged."""

    def spec_for(name, leaf):
        spec = _gpt_leaf_spec(name)
        if spec is None:
            return _replicated(leaf)
        if name.startswith("layers_stacked"):
            return P(None, *spec, groups=spec.groups)
        return spec

    return _map_named(spec_for, params)


def conformer_param_spec(params: Any) -> Any:
    """Tensor-parallel specs for a JAX-layout conformer tree
    (``nn/conformer.py:init_w2vbert_params``): attention q, k, v and the ffn
    input column-parallel, attention out and ffn output row-parallel, the
    pointwise and depthwise convs over channels (``pw1`` pair-wise for its
    GLU); norms and the distance embeddings replicated."""

    def spec_for(keys, leaf):
        keys = "/" + keys
        if "/attn/" in keys and "/kernel" in keys:
            if "/out/" in keys:
                return P("tp", None)
            if any(f"/{q}/" in keys for q in ("q", "k", "v")):
                return P(None, "tp")
        if "/attn/" in keys and "/bias" in keys and "/out/" not in keys:
            return P("tp")
        if ("ffn1/" in keys or "ffn2/" in keys) and "/kernel" in keys:
            return P(None, "tp") if "/in/" in keys else P("tp", None)
        if ("ffn1/" in keys or "ffn2/" in keys) and "/bias" in keys and "/in/" in keys:
            return P("tp")
        if "conv/pw1/kernel" in keys:
            return P(None, "tp", groups=2)
        if "conv/pw2/kernel" in keys:
            return P("tp", None)
        if "conv/dw_kernel" in keys:
            return P(None, None, "tp")  # depthwise channels on tp
        return _replicated(leaf)

    return _map_named(spec_for, params)


def data_parallel_shardings(mesh=None, axis: str = "dp"):
    """(parameter spec, input spec) of data-parallel inference: parameters
    replicated, the batch axis split over ``axis``."""
    return P(), P(axis)


def _sizes_and_coords(mesh, rank: int):
    shape: Mapping[str, int] = getattr(mesh, "shape", mesh)
    coords = np.unravel_index(rank, tuple(shape.values()))
    return dict(shape), dict(zip(shape, (int(c) for c in coords)))


def _block_index(length: int, groups: int, n: int, i: int) -> np.ndarray:
    """Indices of block i of n in each of ``groups`` equal blocks of a dim."""
    if length % (groups * n):
        raise ValueError(f"a dim of {length} does not split into {groups} x {n} blocks")
    g, b = length // groups, length // (groups * n)
    return np.concatenate([np.arange(j * g + i * b, j * g + (i + 1) * b) for j in range(groups)])


def shard_leaf(a, spec: P, sizes: Dict[str, int], coords: Dict[str, int]) -> np.ndarray:
    """The shard of array ``a`` at mesh coordinates ``coords``."""
    a = np.asarray(a)
    for d, ax in enumerate(spec):
        if ax is not None and sizes.get(ax, 1) > 1:
            a = np.take(a, _block_index(a.shape[d], spec.groups, sizes[ax], coords[ax]), axis=d)
    return a


def shard_tree(tree: Any, spec: Any, mesh, rank: int) -> Any:
    """Rank ``rank``'s local numpy shard of a JAX-layout ``tree`` under a
    spec tree; ``mesh`` is a :class:`~.mesh.Mesh` or a {axis: size} map.
    The result loads through ``weights.py``'s ``*_from_numpy`` bridges."""
    sizes, coords = _sizes_and_coords(mesh, rank)
    flat_spec = {}
    _map_named(lambda n, s: flat_spec.setdefault(n, s), spec)
    return _map_named(lambda n, a: shard_leaf(a, flat_spec[n], sizes, coords), tree)


def join_shards(shards: List[Any], spec: Any, mesh) -> Any:
    """The inverse of :func:`shard_tree` over every rank's shard (rank
    order): the full tree. Ranks that hold the same piece must agree on it,
    bit for bit."""
    sizes, _ = _sizes_and_coords(mesh, 0)
    coords = [_sizes_and_coords(mesh, r)[1] for r in range(len(shards))]
    flat = [{} for _ in shards]
    for f, s in zip(flat, shards):
        _map_named(lambda n, a, f=f: f.setdefault(n, np.asarray(a)), s)
    flat_spec = {}
    _map_named(lambda n, s: flat_spec.setdefault(n, s), spec)

    def join(name, _leaf):
        p = flat_spec[name]
        full_shape = list(flat[0][name].shape)
        for d, ax in enumerate(p):
            if ax is not None:
                full_shape[d] *= sizes.get(ax, 1)
        out = np.zeros(full_shape, flat[0][name].dtype)
        seen = np.zeros(full_shape, bool)
        for f, c in zip(flat, coords):
            idx = tuple(_block_index(full_shape[d], p.groups, sizes[ax], c[ax])
                        if ax is not None and sizes.get(ax, 1) > 1 else slice(None)
                        for d, ax in enumerate(p))
            idx = np.ix_(*[np.arange(full_shape[d])[i] for d, i in enumerate(idx)])
            if seen[idx].any() and not np.array_equal(out[idx], f[name]):
                raise ValueError(f"join_shards: ranks disagree on {name}")
            out[idx], seen[idx] = f[name], True
        return out

    return _map_named(join, shards[0])
