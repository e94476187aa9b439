"""Expert-parallel MoE: all-to-all dispatch to the experts' owner ranks.

The twin of the JAX package's ``repro/dist/ep.py`` (``moe_apply_ep``),
per rank over a ``DeviceMesh`` with a ``model`` dim.  The GSPMD path
(:func:`repro_torch.nn.moe.moe_apply`) routes every token on every rank
through all the experts.  Here the ranks of one ``model`` group hold the
same ``(B/data, S, d)`` activations on entry, and each rank

1. takes its ``S/model`` slice of the sequence;
2. routes its local tokens with ``nn/moe.py``'s helpers (the same
   router, capacity, sort-based plan and gather as the GSPMD path);
3. sends the ``(model, E_loc, C, d)`` buffer to the experts' owners with
   one all-to-all;
4. runs its ``E_loc = E/model`` experts' SwiGLU, the gate einsum and its
   NL-ADC one grouped kernel on the ``cuda`` backend
   (:func:`~repro_torch.core.analog_layer.moe_gate_nladc`, kernel 4, at
   ``(E_loc, model * C, d, f)``);
5. sends the results back with a second all-to-all and combines them onto
   its tokens, adding the shared experts;
6. all-gathers the sequence over ``model``.

A rank holds only its own experts, as a device of the reference's
global arrays holds only its shard: :func:`place_experts` cuts each
expert stack once, where the params are placed (``LM.init`` with a mesh
draws one layer's stacks at a time and keeps the rank's slice), by
:func:`repro_torch.dist.sharding.ep_param_specs` and
:func:`~repro_torch.dist.sharding.local_shard`, so the layout and this
path cannot drift.  The expert stacks' gradients and optimizer state are
then the rank's share alone.

The numerics match the GSPMD path to float tolerance whenever nothing is
capacity-dropped (a per-(expert, sender) capacity replaces the global
per-expert one).  The load-balance loss all-reduces the load and the
importance over every token-partitioning group (``pod``, ``data``,
``model``) and forms the Switch loss over the whole token set, as the
reference does.

Gradients are the transpose of the reference's layout (the collectives
of :mod:`repro_torch.dist.collectives`): the loss after the all-gather
is computed alike on every rank of the model group, so the all-gather's
backward keeps the rank's slice and the sequence split's backward
gathers; the router's and the shared experts' gradients (replicated
inputs) are summed over the model group; an expert's gradient stays on
its owner rank, a gradient of the rank's slice.
Gradients over the data-like axes are the data-parallel step's to sum.

It falls back to :func:`~repro_torch.nn.moe.moe_apply` where the
reference does: no mesh with a ``model`` dim above 1, ``E % model``,
``S % model``, or a decode step (S = 1); with placed experts it first
all-gathers the stacks over ``model`` (the backward keeps the rank's
slice), as GSPMD gathers the reference's sharded ones.  The reference's ``B % data``
condition is the caller's here: a rank holds the rows the caller gave it
(:func:`repro_torch.dist.sharding.batch_specs` splits a batch only where
the data axes divide it, and the load-balance loss's normalized sums are
unchanged by ranks that hold the same rows).  Train mode's ramp draws
are the caller's (``draws``, as ``moe_apply``'s): the reference folds
the token replica index into each shard's key, so its shards draw
independent ramps where the port's model group shares one draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.analog_layer import AnalogActivation, RampDraws, \
    moe_gate_nladc
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.nn import moe as MOE
from repro_torch.nn.mlp import mlp_apply
from repro_torch.train.optim import tree_map


def _usable(mesh, x: torch.Tensor, n_experts: int,
            ep_axis: str = "model") -> bool:
    """Whether ``x`` takes the expert-parallel path on ``mesh``."""
    if mesh is None or x.ndim != 3:
        return False
    size = SH.mesh_shape(mesh).get(ep_axis, 1)
    return (size > 1 and n_experts % size == 0 and x.shape[1] % size == 0)


def _splits(mesh, n_experts: int, ep_axis: str) -> int:
    """The parts the expert stacks split into over ``ep_axis`` (1: they do
    not split)."""
    size = 1 if mesh is None else SH.mesh_shape(mesh).get(ep_axis, 1)
    return size if size > 1 and n_experts % size == 0 else 1


def place_experts(params, mesh, ep_axis: str = "model"):
    """``params`` (a model's tree or one MoE block's) with every expert
    stack cut to this rank's experts, as :func:`moe_apply_ep` takes them:
    the slice by :func:`~repro_torch.dist.sharding.ep_param_specs`, copied
    out of the full stack so that the full one is freed with the caller's
    tree.  The router, the shared experts and the rest are kept as given,
    and so is every stack where the experts do not split over
    ``ep_axis``."""
    specs = SH.ep_param_specs(params, ep_axis)
    coords = SH.mesh_coords(mesh) if mesh is not None else None

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sv) for v, sv in zip(t, s)]
        if not s or _splits(mesh, t.shape[s.index(ep_axis)], ep_axis) == 1:
            return t
        return SH.local_shard(t, s, mesh, coords).clone()

    return walk(params, specs)


def moe_apply_ep(p, x: torch.Tensor, *, top_k: int, capacity_factor: float,
                 act: AnalogActivation, router_score: str = "softmax",
                 router_act: Optional[AnalogActivation] = None,
                 draws: Optional[RampDraws] = None, mesh=None,
                 ep_axis: str = "model", return_aux: bool = False):
    """:func:`~repro_torch.nn.moe.moe_apply` with explicit all-to-alls.

    x: this rank's (B/data, S, d), the same on every rank of its
    ``ep_axis`` group; ``p``: the MoE params with this rank's experts
    (:func:`place_experts`).  Returns the (B/data, S, d) output (the same
    on every rank of the group) and, with ``return_aux``, the load-balance
    loss over every rank's tokens."""
    n_experts = p["router"].shape[-1]
    parts = _splits(mesh, n_experts, ep_axis)
    if p["w_gate"].shape[0] * parts != n_experts:
        raise ValueError(
            f"{p['w_gate'].shape[0]} experts on a rank of {parts} for "
            f"{n_experts}: place the experts with place_experts")
    if not _usable(mesh, x, n_experts, ep_axis):
        if parts > 1:
            group = mesh.get_group(ep_axis)
            p = {**p, **{k: C.gather_from_group(p[k], 0, group)
                         for k in ("w_gate", "w_up", "w_down")}}
        return MOE.moe_apply(
            p, x, top_k=top_k, capacity_factor=capacity_factor, act=act,
            router_score=router_score, router_act=router_act, draws=draws,
            return_aux=return_aux)
    group = mesh.get_group(ep_axis)
    m_size = SH.mesh_shape(mesh)[ep_axis]
    tok_axes = SH.data_axes(mesh) + (ep_axis,)

    xl = C.split_to_group(x, 1, group)                  # (b, S/model, d)
    b, s, d = xl.shape
    xf = xl.reshape(-1, d)
    n = xf.shape[0]
    router = C.copy_to_group(p["router"], group)
    logits = xf @ router.to(xf.dtype)
    gates, idx, probs_f32 = MOE.router_gates(logits, top_k, router_score,
                                             router_act)
    capacity = MOE.expert_capacity(n, top_k, n_experts, capacity_factor)
    st, sg, dest, valid = MOE.dispatch_plan(idx, gates, n, n_experts,
                                            capacity)
    x_buf = MOE.gather_expert_buffer(xf, st, dest, valid, n_experts,
                                     capacity)                  # (E, C, d)

    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    e_loc = w_gate.shape[0]

    # all-to-all: slots travel to their expert-owner rank, then
    # (peer, E_loc, C, d) -> (E_loc, peer * C, d): per-expert batches over
    # every sender's slots
    recv = C.all_to_all(x_buf.reshape(m_size, e_loc, capacity, d), group)
    xb = recv.transpose(0, 1).reshape(e_loc, m_size * capacity, d)

    gate_h = moe_gate_nladc(xb, w_gate, act,
                            z=act.ramp_z(draws, w_gate.shape[-1]))
    up_h = torch.einsum("end,edf->enf", xb, w_up.to(xb.dtype))
    h = torch.einsum("enf,efd->end", gate_h * up_h, w_down.to(xb.dtype))

    # the return trip, then the combine onto the local tokens
    hb = h.reshape(e_loc, m_size, capacity, d).transpose(0, 1).contiguous()
    h_full = C.all_to_all(hb, group).reshape(n_experts, capacity, d)
    out = MOE.combine_expert_buffer(h_full, xf, st, sg, dest, valid)
    if "shared" in p:
        shared = tree_map(lambda t: C.copy_to_group(t, group), p["shared"])
        out = out + mlp_apply(shared, xf, "swiglu", act, draws=draws)
    out = C.gather_from_group(out.reshape(b, s, d), 1, group)
    if not return_aux:
        return out

    # the global load-balance loss: the per-rank count and importance
    # sums reduced over every token-partitioning group
    if probs_f32 is None:
        probs_f32 = MOE._softmax(logits.float())
    flat = idx.reshape(-1)
    load = torch.zeros(n_experts, dtype=torch.float32, device=x.device)
    load = load.index_add(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                              device=x.device))
    imp = torch.sum(probs_f32, dim=0)
    count = torch.full((), float(n), dtype=torch.float32, device=x.device)
    for ax in tok_axes:
        g = mesh.get_group(ax)
        load = C.reduce_to_replicated(load, g)
        imp = C.reduce_to_replicated(imp, g)
        count = C.reduce_to_replicated(count, g)
    load = load / torch.clamp_min(torch.sum(load), 1.0)
    aux = n_experts * torch.sum(imp / count * load)
    return out, aux
