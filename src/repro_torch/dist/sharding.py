"""Layout rules: a spec for every param, batch and decode-state leaf, and
the rank's slice of a full tree by those specs.

The twin of the JAX package's ``repro/dist/sharding.py``, with its rule
table and results.  A spec is a plain tuple with one entry per dim: an
axis name, a tuple of axis names (the batch dim over every data-like
axis), or ``None``; the empty tuple is the reference's ``P()``
(replicated).  The functions read only ``.shape``, so they work on meta
tensors as on real ones; a tree is nested dicts and lists (the port's
per-layer ``layers`` list and the reference's stacked layout alike), and
a path's keys are the dict keys and the list indices as strings, as the
reference's ``_path_keys`` spells them.

* **Params** — megatron tensor parallelism on the ``model`` axis,
  replicated over ``pod``/``data``: QKV and MLP-in projections
  column-parallel, attention-out and MLP-out row-parallel, MoE expert
  stacks expert-parallel, embeddings and LM heads vocab-parallel, RG-LRU
  block-diagonal gates block-parallel; a dim shards only where the model
  axis divides it.
* **Batches** — the leading dim over every data-like axis (``pod`` and
  ``data``).
* **Decode state** — the batch dim (1 for the reference's stacked
  subtrees, 0 otherwise and in the port's per-layer lists) over the
  data-like axes.

:func:`local_shard` is the port's counterpart of the placement that a
``shard_map``'s in-specs make: it cuts a rank's slice of a full tree.
The expert-parallel MoE (:mod:`repro_torch.dist.ep`) takes its experts
with it from :func:`ep_param_specs`, so the layout and that path cannot
drift.  The reference's ``shardings_for`` (specs -> ``NamedSharding``)
has no counterpart: a torch rank holds tensors, not a global array with
a sharding, and :func:`local_shard` is what places them.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or anything
with ``axis_names`` and a ``shape`` mapping (a mesh that is only
planned, as the reference's tests fake one).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

# Dense projections whose *output* features are sharded (column-parallel);
# their biases shard the same way.
_COL_PARALLEL = frozenset((
    "wq", "wk", "wv",            # attention QKV
    "wi", "wi_gate", "wi_up",    # MLP in-projections
    "wx", "wg",                  # RG-LRU in/gate projections
    "in_proj",                   # SSD fused in-projection
    "lm_head",                   # untied readout (vocab-parallel)
    "w_gates", "w_proj",         # LSTM workloads
))
# Dense projections whose *input* features are sharded (row-parallel).
_ROW_PARALLEL = frozenset(("wo", "out_proj"))
# Raw (non-dict) block-diagonal gate stacks: shard the block dim.
_BLOCK_PARALLEL = frozenset(("wa",))
# Raw stacked expert weights: shard the expert dim.
_EXPERT_PARALLEL = frozenset(("w_gate", "w_up", "w_down"))

# Decode-state subtrees stacked on a leading layer dim (batch dim is 1).
_STACKED_STATE = frozenset(("layers", "groups", "self", "cross_k", "cross_v"))

Spec = Tuple[Any, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, outermost first."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def data_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel-like mesh axes, outermost first."""
    names = mesh_shape(mesh)
    return tuple(ax for ax in ("pod", "data") if ax in names)


def _degree(sizes: Mapping[str, int], axes) -> int:
    n = 1
    for ax in axes:
        n *= sizes[ax]
    return n


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    structure; ``path`` is the keys as strings."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape; () for a Python scalar (a decode state's
    ``index``)."""
    return tuple(getattr(leaf, "shape", ()))


def _single_axis_spec(ndim: int, dim: int, axis: str) -> Spec:
    return tuple(axis if i == dim else None for i in range(ndim))


def _param_spec(keys: Tuple[str, ...], shape: Tuple[int, ...],
                msize: int, model_axis: str) -> Spec:
    """The megatron rule table for one parameter leaf."""
    ndim = len(shape)
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) > 1 else ""

    def sharded(dim: int) -> Spec:
        if 0 <= dim < ndim and shape[dim] % msize == 0:
            return _single_axis_spec(ndim, dim, model_axis)
        return ()

    if name == "table":                      # embedding: vocab-parallel
        return sharded(ndim - 2)
    if name in ("w", "b") and parent in _COL_PARALLEL:
        return sharded(ndim - 1)
    if name == "w" and parent in _ROW_PARALLEL:
        return sharded(ndim - 2)
    if name in _EXPERT_PARALLEL and ndim >= 3:
        return sharded(ndim - 3)
    if name in _BLOCK_PARALLEL and ndim >= 3:
        return sharded(ndim - 3)
    if name == "wi" and ndim >= 3:           # RG-LRU raw gate stack (not the
        return sharded(ndim - 3)             # dict-valued MLP "wi")
    return ()


def param_specs(tree: Any, mesh, *, replicate_all: bool = False,
                model_axis: str = "model") -> Any:
    """A spec tree (the structure of ``tree``) for parameters.
    ``replicate_all`` keeps every param replicated (the SSM family runs
    pure data-parallel)."""
    msize = mesh_shape(mesh).get(model_axis, 1)

    def spec(path, leaf) -> Spec:
        if replicate_all or msize <= 1:
            return ()
        return _param_spec(path, _shape(leaf), msize, model_axis)

    return tree_map_with_path(spec, tree)


def ep_param_specs(tree: Any, ep_axis: str = "model") -> Any:
    """The expert-parallel MoE's layout: the expert stacks (the
    ``_EXPERT_PARALLEL`` entries of the rule table) shard their expert
    dim over ``ep_axis``; the router, the shared experts and the rest
    are replicated."""

    def spec(path, leaf) -> Spec:
        name, ndim = (path[-1] if path else ""), len(_shape(leaf))
        if name in _EXPERT_PARALLEL and ndim >= 3:
            return _single_axis_spec(ndim, ndim - 3, ep_axis)
        return ()

    return tree_map_with_path(spec, tree)


def batch_specs(batch: Any, mesh) -> Any:
    """Shard the leading (global-batch) dim over the data-like axes."""
    baxes = data_axes(mesh)
    degree = _degree(mesh_shape(mesh), baxes)

    def spec(path, leaf) -> Spec:
        shape = _shape(leaf)
        if not shape or not baxes or shape[0] % degree:
            return ()
        return (baxes,) + (None,) * (len(shape) - 1)

    return tree_map_with_path(spec, batch)


def decode_state_specs(state: Any, mesh) -> Any:
    """Shard decode-state caches over the data-like axes on the batch
    dim."""
    baxes = data_axes(mesh)
    degree = _degree(mesh_shape(mesh), baxes)

    def spec(path, leaf) -> Spec:
        shape = _shape(leaf)
        if not shape or not baxes:
            return ()
        # the reference's stacked subtrees carry a leading layer dim; the
        # port keeps a list of per-layer dicts there, batch on dim 0
        stacked = path and path[0] in _STACKED_STATE and not (
            len(path) > 1 and path[1].isdigit())
        bdim = 1 if stacked else 0
        if bdim >= len(shape) or shape[bdim] % degree:
            return ()
        return tuple(baxes if i == bdim else None for i in range(len(shape)))

    return tree_map_with_path(spec, state)


def _leaf_slice(leaf, spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]):
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for ax in axes:                       # outermost first
            parts *= sizes[ax]
            index = index * sizes[ax] + coords[ax]
        n = leaf.shape[dim]
        if n % parts:
            raise ValueError(f"dim {dim} of a leaf of shape "
                             f"{tuple(leaf.shape)} does not split {parts} "
                             f"ways over {axes}")
        leaf = leaf.narrow(dim, index * (n // parts), n // parts)
    return leaf


def local_shard(tree: Any, specs: Any, mesh,
                coords: Mapping[str, int]) -> Any:
    """This rank's slice of a full ``tree`` by ``specs`` (the structure
    of ``tree``): every dim a spec names is cut into equal parts over its
    axes (linearized outermost first) and the part at ``coords`` (axis
    name -> this rank's index on it, as ``DeviceMesh.get_local_rank``
    gives it) kept.  The slices are views of the full leaves (no copy;
    differentiable, so a gradient reaches only this rank's part)."""
    sizes = mesh_shape(mesh)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sv) for v, sv in zip(t, s)]
        return _leaf_slice(t, s, sizes, coords)

    return walk(tree, specs)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index on every dim of a ``DeviceMesh``."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}
