"""Mixture-of-Experts: token-choice top-k routing with capacity + shared
experts.

The serving slice of the JAX package's ``repro/nn/moe.py``, with its
names and layouts: Deepseek-MoE / Moonlight style fine-grained MoE (64
routed experts, top-6, plus always-on shared experts), dispatched by the
sort-based capacity formulation:

  1. top-k per token -> (token, expert, gate) slot triples;
  2. stable-sort slots by expert; position within the expert from an
     exclusive cumsum of expert counts; slots beyond capacity C dropped;
  3. tokens gathered into an (E, C, d) buffer, per-expert SwiGLU einsum
     (the gate einsum and its NL-ADC one grouped kernel on the ``cuda``
     backend), weighted sum back onto the tokens.

A sigmoid router (``router_score="sigmoid"``, moonlight) is elementwise
and is NL-ADC'd; a softmax router stays full precision.  The reference's
sharding constraints (``_maybe_shard``) are the identity on one device;
expert parallelism over ``torch.distributed`` is ROADMAP.md queue A item
6.  Training adds the Switch-style load-balance loss
(:func:`aux_load_balance_loss`, ``moe_apply(..., return_aux=True)``).

Three places where a plain port would give another answer than the
reference, and what this module does:

* ties in top-k: ``jax.lax.top_k`` puts the lower index first, and a
  5-bit sigmoid NL-ADC gives the router's scores a few dozen levels, so
  ties are common; ``torch.topk`` promises no order, so
  :func:`stable_top_k` takes the first k of a stable descending sort;
* the dispatch sort is ``torch.argsort(..., stable=True)``, as
  ``jnp.argsort(..., stable=True)``;
* the combine: ``zeros.at[token].add(contrib)`` adds a token's
  contributions one after another in slot order, which after the stable
  sort is ascending expert order, each add rounded to the compute dtype.
  :func:`combine_expert_buffer` adds them in that order (no atomics, so
  the sum is the same on every run and every device).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.analog_layer import AnalogActivation, RampDraws, \
    moe_gate_nladc
from repro_torch.nn import layers as L
from repro_torch.nn.mlp import mlp_apply, mlp_init


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, n_shared: int, kind: str = "swiglu"):
    """Seeded float32 params on the generator's device: the ``router``
    (d, E), the stacked routed experts ``w_gate``/``w_up`` (E, d, ff) and
    ``w_down`` (E, ff, d), and the ``shared`` experts as one MLP of width
    ``n_shared * d_ff``."""
    dev = generator.device
    scale = 1.0 / math.sqrt(d_model)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev).mul_(scale)

    p = {
        "router": L.trunc_normal(generator, (d_model, n_experts), 1.0),
        "w_gate": normal((n_experts, d_model, d_ff)),
        "w_up": normal((n_experts, d_model, d_ff)),
        "w_down": normal((n_experts, d_ff, d_model)).div_(
            math.sqrt(d_ff / d_model)),
    }
    if n_shared > 0:
        p["shared"] = mlp_init(generator, d_model, n_shared * d_ff, kind)
    return p


def stable_top_k(scores: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest scores along the last axis,
    ties broken toward the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def router_gates(logits: torch.Tensor, top_k: int, score: str,
                 router_act: Optional[AnalogActivation]):
    """Top-k gates.  softmax: probabilities (float32), then top-k; sigmoid:
    NL-ADC'd scores, top-k, then normalized (deepseek-v3/moonlight).

    Returns ``(gates in logits' dtype, indices, probs)``: ``probs`` are the
    float32 softmax probabilities the load-balance loss reads, for the
    softmax router; the sigmoid router returns None there, and
    :func:`moe_apply` computes the softmax only when it returns the loss
    (the reference computes one that serving never reads).
    """
    if score == "sigmoid":
        probs = router_act(logits) if router_act is not None \
            else torch.sigmoid(logits)
        gates, idx = stable_top_k(probs, top_k)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        probs_f32 = None
    else:
        probs_f32 = _softmax(logits.float())
        gates, idx = stable_top_k(probs_f32, top_k)
    return gates.to(logits.dtype), idx, probs_f32


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` op for op: ``exp(x - max) / sum``."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def aux_load_balance_loss(probs_f32: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean prob x mean load):
    the load counts each routing slot once (whole numbers: exact in any
    order)."""
    flat = idx.reshape(-1)
    load = torch.zeros(n_experts, dtype=torch.float32, device=idx.device)
    load = load.index_add(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                              device=idx.device))
    load = load / torch.clamp_min(torch.sum(load), 1.0)
    imp = torch.mean(probs_f32, dim=0)
    return n_experts * torch.sum(imp * load)


def dispatch_plan(idx: torch.Tensor, gates: torch.Tensor, n_tokens: int,
                  n_experts: int, capacity: int):
    """Sort-based slot assignment.

    Returns (st, sg, dest, valid): source token, gate weight, destination
    slot in the flattened (E*C [+1 overflow]) buffer, and the
    within-capacity mask, one entry per (token, expert) routing slot, in
    the stable expert order.
    """
    k = idx.shape[-1]
    dev = idx.device
    slot_expert = idx.reshape(-1)
    slot_token = torch.arange(n_tokens, device=dev).repeat_interleave(k)
    slot_gate = gates.reshape(-1)
    order = torch.argsort(slot_expert, stable=True)
    se = slot_expert[order]
    st = slot_token[order]
    sg = slot_gate[order]
    # the exclusive cumsum of the expert counts, read off the sorted
    # experts (a bincount would wait on the device for its output size)
    offsets = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos_in_e = torch.arange(se.shape[0], device=dev) - offsets[se]
    valid = pos_in_e < capacity
    dump = n_experts * capacity                          # overflow slot
    dest = torch.where(valid, se * capacity
                       + torch.clamp_max(pos_in_e, capacity - 1), dump)
    return st, sg, dest, valid


def gather_expert_buffer(xf: torch.Tensor, st, dest, valid, n_experts: int,
                         capacity: int) -> torch.Tensor:
    """Gather routed tokens into the (E, C, d) expert input buffer; empty
    capacity rows are zeros."""
    n_buf = n_experts * capacity + 1
    token_for_slot = torch.zeros(n_buf, dtype=st.dtype, device=xf.device)
    token_for_slot[dest] = st
    slot_used = torch.zeros(n_buf, dtype=xf.dtype, device=xf.device)
    slot_used[dest] = valid.to(xf.dtype)
    x_buf = xf[token_for_slot[:-1]] * slot_used[:-1, None]
    return x_buf.reshape(n_experts, capacity, xf.shape[-1])


def combine_expert_buffer(h: torch.Tensor, xf: torch.Tensor, st, sg, dest,
                          valid) -> torch.Tensor:
    """Weighted sum of the expert outputs back onto the tokens.

    Each token's ``top_k`` contributions are added to zero one after
    another in slot order (ascending expert), each add in the compute
    dtype: the order of the reference's sequential scatter-add.
    """
    n_slots = h.shape[0] * h.shape[1]
    h_flat = h.reshape(n_slots, h.shape[-1])
    contrib = h_flat[torch.clamp_max(dest, n_slots - 1)] \
        * (sg * valid.to(sg.dtype))[:, None]
    n_tokens = xf.shape[0]
    k = st.shape[0] // n_tokens
    # every token holds exactly k slots; a stable sort by token keeps each
    # token's slots in their (expert) order
    by_token = contrib[torch.argsort(st, stable=True)].reshape(
        n_tokens, k, -1)
    out = torch.zeros_like(xf)
    for j in range(k):
        out = out + by_token[:, j]
    return out


def expert_capacity(n_tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    return max(int(math.ceil(n_tokens * top_k / n_experts
                             * capacity_factor)), top_k)


def moe_apply(p, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              act: AnalogActivation, router_score: str = "softmax",
              router_act: Optional[AnalogActivation] = None,
              draws: Optional[RampDraws] = None,
              return_aux: bool = False):
    """x: (..., d) -> (..., d), and with ``return_aux`` the load-balance
    loss beside it.  Flattens leading dims for routing.  ``draws``: the
    layer's train-mode ramp draws
    (:class:`~repro_torch.core.analog_layer.RampDraws`): the routed
    experts' gate and the shared experts' take them from one key in the
    reference."""
    orig_shape = x.shape
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    n_experts = p["router"].shape[-1]

    logits = xf @ p["router"].to(xf.dtype)
    gates, idx, probs_f32 = router_gates(logits, top_k, router_score,
                                         router_act)

    # slot assignment (sort by expert, capacity-crop)
    capacity = expert_capacity(n, top_k, n_experts, capacity_factor)
    st, sg, dest, valid = dispatch_plan(idx, gates, n, n_experts, capacity)

    # dispatch: gather tokens into the (E, C, d) expert buffer
    x_buf = gather_expert_buffer(xf, st, dest, valid, n_experts, capacity)

    # expert FFN: the gate einsum + NL-ADC pair is one grouped kernel on
    # the cuda backend
    gate_h = moe_gate_nladc(x_buf, p["w_gate"], act,
                            z=act.ramp_z(draws, p["w_gate"].shape[-1]))
    up_h = torch.einsum("ecd,edf->ecf", x_buf, p["w_up"].to(x_buf.dtype))
    h = torch.einsum("ecf,efd->ecd", gate_h * up_h,
                     p["w_down"].to(x_buf.dtype))

    # combine: weighted sum back onto the tokens
    out = combine_expert_buffer(h, xf, st, sg, dest, valid)

    # shared experts (always on)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xf, "swiglu", act, draws=draws)
    out = out.reshape(orig_shape)
    if return_aux:
        if probs_f32 is None:
            probs_f32 = _softmax(logits.float())
        return out, aux_load_balance_loss(probs_f32, idx, n_experts)
    return out
