"""Gradient collectives and the expert-parallel path's autograd-aware
collectives, per rank over the process groups of a ``DeviceMesh``.

The twin of the JAX package's ``repro/dist/collectives.py``.  There the
functions are per-device code inside ``shard_map`` over named axes; here
they are per-rank code, and an axis is the process group of that dim of
the mesh (``mesh.get_group(name)``).

* :func:`grad_allreduce` — the train step's reduction: ``psum`` (a flat
  all-reduce over the data-like axes), ``hierarchical``
  (:func:`hierarchical_grad_allreduce`: reduce-scatter over ``data``, the
  leading dim zero-padded to a multiple of its size and cropped after,
  then an all-reduce of the shard over ``pod``, then an all-gather over
  ``data``; scalars take the flat all-reduce) or ``int8``
  (:func:`repro_torch.dist.compress.compressed_psum`).  Every element is
  summed over the same ranks as the flat all-reduce, in another order, so
  the two agree to float32 rounding.
* The expert-parallel MoE's collectives, as ``torch.autograd.Function``s
  with the layout's backward: :func:`split_to_group` (a rank keeps its
  slice; the backward gathers the slices), :func:`gather_from_group` (the
  slices gathered; the backward keeps the rank's slice), :func:`copy_to_group`
  (identity; the backward sums over the group: the transpose of a
  replicated input, as the reference's ``shard_map`` in-spec ``P()``
  gives), :func:`reduce_to_replicated` (an all-reduce whose result every
  rank consumes alike; the backward is the identity) and
  :func:`all_to_all` (equal splits of dim 0; the backward is the same
  exchange).  They are written here rather than taken from
  ``torch.distributed.nn.functional`` for two reasons: those call the
  process group directly, so a gloo group would meet CUDA tensors, and
  their ``all_gather`` and ``all_reduce`` backward sums the gradients of
  every rank, which double-counts a loss that the ranks of the group
  compute alike (the model group's replicated activations).

**Staging (the transport).**  NCCL cannot put two ranks on one GPU, so a
group of ranks that share a card runs gloo, and gloo reduces host memory.
Every collective of this package goes through :func:`_run`, the one place
where, when the group's backend is gloo and the tensor lies on a CUDA
device, the tensor is copied to the host, reduced there, and the result
copied back.  The compute stays on the card; only the collective's bytes
cross.  :data:`STAGED` counts the bytes and calls staged so a run can
print them (``STAGED.reset()`` first).  An NCCL group, and a gloo group
of CPU tensors, stages nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.train.optim import tree_map


@dataclasses.dataclass
class StagingStats:
    """Bytes copied device -> host and host -> device by staged
    collectives, and the count of those collectives."""

    bytes: int = 0
    calls: int = 0

    def reset(self) -> None:
        self.bytes = 0
        self.calls = 0


STAGED = StagingStats()


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(op, out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """``op(out, inp, group)`` on the group's transport: through host
    copies when a gloo group meets CUDA tensors (see the module
    docstring), else on the tensors themselves.  Returns ``out``."""
    if not _staged(inp, group):
        op(out, inp, group)
        return out
    h_in = inp.detach().cpu()
    h_out = h_in if out is inp else torch.empty(
        out.shape, dtype=out.dtype, device="cpu")
    op(h_out, h_in, group)
    out.copy_(h_out)
    STAGED.bytes += h_in.nbytes + h_out.nbytes
    STAGED.calls += 1
    return out


def _all_reduce_(out, inp, group, op=dist.ReduceOp.SUM):
    return _run(lambda o, i, g: dist.all_reduce(o, op=op, group=g),
                out, inp, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group`` (no autograd)."""
    y = x.detach().clone()
    return _all_reduce_(y, y, group)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's equal part of dim 0
    (the reference's ``psum_scatter(tiled=True)``)."""
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _run(lambda o, i, g: dist.reduce_scatter_tensor(o, i, group=g),
                out, x.detach().contiguous(), group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group rank order
    (the reference's ``all_gather(tiled=True)``)."""
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] * n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _run(lambda o, i, g: dist.all_gather_into_tensor(o, i, group=g),
                out, x.detach().contiguous(), group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    return _run(lambda o, i, g: dist.all_to_all_single(o, i, group=g),
                out, x.detach().contiguous(), group)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def replica_index(mesh, axes) -> int:
    """Linearized index of this rank over ``axes`` (outermost first): the
    per-replica seed of a data-parallel step's noise."""
    rep = 0
    for ax in axes:
        rep = rep * axis_size(mesh, ax) + mesh.get_local_rank(ax)
    return rep


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over every rank of ``axes`` (one
    all-reduce per axis, innermost first)."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A new tensor: the largest ``x`` over every rank of ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX)


def _reduce(x, mesh, axes, op):
    y = x.detach().clone()
    for ax in reversed(tuple(axes)):
        _all_reduce_(y, y, mesh.get_group(ax), op)
    return y


def _hier_one(x: torch.Tensor, mesh, data_axis: str,
              pod_axis: Optional[str]) -> torch.Tensor:
    if x.ndim == 0:
        # a scalar cannot reduce-scatter; the flat all-reduce is minimal
        axes = (pod_axis, data_axis) if pod_axis else (data_axis,)
        return psum(x, mesh, axes)
    n_data = axis_size(mesh, data_axis)
    n = x.shape[0]
    pad = (-n) % n_data
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    shard = reduce_scatter(x, mesh.get_group(data_axis))
    if pod_axis is not None:
        _all_reduce_(shard, shard, mesh.get_group(pod_axis))
    full = all_gather(shard, mesh.get_group(data_axis))
    return full[:n] if pad else full


def hierarchical_grad_allreduce(grads: Any, mesh, data_axis: str = "data",
                                pod_axis: Optional[str] = None) -> Any:
    """Reduce-scatter over ``data`` -> all-reduce over ``pod`` ->
    all-gather over ``data``, over a gradient tree.  ``pod_axis=None``
    (a mesh without ``pod``) is the one-level reduce-scatter ->
    all-gather.  Leaves whose leading dim does not divide the data axis
    are zero-padded for the scatter and cropped after the gather."""
    return tree_map(lambda g: _hier_one(g, mesh, data_axis, pod_axis), grads)


def grad_allreduce(grads: Any, mesh, *, mode: str = "psum",
                   data_axis: str = "data",
                   pod_axis: Optional[str] = None) -> Any:
    """The train step's gradient reduction: ``psum`` (flat all-reduce
    over the data-like axes), ``hierarchical``
    (:func:`hierarchical_grad_allreduce`) or ``int8`` (the shared-scale
    int8 wire format, :func:`repro_torch.dist.compress.compressed_psum`)."""
    axes = (pod_axis, data_axis) if pod_axis else (data_axis,)
    if mode == "psum":
        return tree_map(lambda g: psum(g, mesh, axes), grads)
    if mode == "hierarchical":
        return hierarchical_grad_allreduce(grads, mesh, data_axis=data_axis,
                                           pod_axis=pod_axis)
    if mode == "int8":
        from repro_torch.dist.compress import compressed_psum

        return compressed_psum(grads, mesh, axes)
    raise ValueError(f"unknown grad_allreduce mode {mode!r}")


# -- the expert-parallel path's autograd-aware collectives -------------------

def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    moved = x.movedim(dim, 0).contiguous()
    return all_gather(moved, group).movedim(0, dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def split_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal slice of ``x`` (the same on every rank of
    ``group``) along ``dim``; the backward gathers every rank's slice of
    the gradient, so the replicated input gets the whole gradient."""
    return _Split.apply(x, dim, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, for a consumer that
    every rank of ``group`` runs alike; the backward keeps this rank's
    slice of the (replicated) gradient."""
    return _Gather.apply(x, dim, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over ``group``) into per-rank work; the backward
    sums the ranks' gradients, the transpose of the replication."""
    return _Copy.apply(x, group)


def reduce_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, for a consumer that every rank
    runs alike; the backward hands each rank the gradient as it is."""
    return _ReduceReplicated.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 in equal parts, part ``j`` to rank ``j`` of ``group``; the
    result's part ``j`` is what rank ``j`` sent (the reference's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``); the
    backward is the same exchange of the gradient."""
    return _AllToAll.apply(x, group)
