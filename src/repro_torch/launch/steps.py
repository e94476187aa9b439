"""Step factories for the LM: the optimizer, the train step, the prefill
and serve steps.

The torch twin of the JAX package's ``repro/launch/steps.py``
(``make_optimizer``, ``make_train_step``, ``make_prefill_step``,
``make_serve_step``, ``build_all``, and the data-parallel
``make_dp_train_step`` / ``make_dp_opt_state``).  The reference derives
every step's randomness from ``jax.random.PRNGKey(seed)``; here a step
draws from the :class:`NoiseSource` that ``noise_for(seed)`` returns, by
default a ``torch.Generator`` on the model's device seeded with ``seed``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.crossbar import GeneratorNoise, NoiseSource
from repro_torch.dist import collectives as C
from repro_torch.dist import compress
from repro_torch.dist.sharding import data_axes
from repro_torch.nn.model import build
from repro_torch.train import optim


def make_optimizer(cfg, total_steps: int = 10000) -> optim.Adam:
    """The reference's LM optimizer: AdamW (weight decay 0.1), gradients
    clipped to global norm 1.0, a cosine schedule peaking at 3e-4."""
    return optim.Adam(
        lr=optim.cosine_schedule(3e-4,
                                 warmup_steps=min(500, total_steps // 10 + 1),
                                 total_steps=total_steps),
        weight_decay=0.1,
        grad_clip_norm=1.0,
    )


def seeded_noise(device: torch.device) -> Callable[[int], NoiseSource]:
    """``seed -> GeneratorNoise`` on ``device`` seeded with ``seed``."""
    def noise_for(seed: int) -> NoiseSource:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return GeneratorNoise(gen)

    return noise_for


def make_train_step(model, optimizer: optim.Adam, *, remat: bool = True,
                    noise_for: Optional[Callable[[int], NoiseSource]] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch, seed) -> (params, opt_state,
    metrics)``: the loss's gradient (``model.loss``, remat as given), then
    one optimizer update.  The update is in place (:meth:`Adam.update_`):
    the returned params are the given tensors, as the reference's jitted
    step donates its inputs.  ``metrics``: the loss's (``loss``,
    ``aux_loss``, ``tokens``) and ``grad_norm``, the gradient's global
    norm before any clip, as 0-dim tensors."""
    noise_for = noise_for or seeded_noise(model.device)

    def train_step(params, opt_state, batch, seed: int):
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = model.loss(params, batch, noise=noise_for(seed),
                                    remat=remat)
        grads = torch.autograd.grad(total, leaves)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        del grads
        grads = optim.tree_map(lambda p: by_leaf[id(p)], params)
        del by_leaf
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optim.global_norm(grads)
        opt_state = optimizer.update_(grads, opt_state, params,
                                      norm=metrics["grad_norm"])
        return params, opt_state, metrics

    return train_step


def make_dp_train_step(model, optimizer: optim.Adam, mesh, *,
                       grad_comm: str = "psum", remat: bool = True,
                       noise_for: Optional[Callable[[int], NoiseSource]]
                       = None) -> Callable:
    """The data-parallel train step with explicit gradient collectives,
    run by every rank of ``mesh``'s data-like dims (``pod``, ``data``):
    ``train_step(params, opt_state, batch, seed) -> (params, opt_state,
    metrics)`` on this rank's rows of the global batch (its slice by
    :func:`repro_torch.dist.sharding.batch_specs`; the caller keeps the
    batch divisible, see :func:`repro_torch.ft.elastic.plan_for_devices`)
    and the replicated params, which it updates in place as
    :func:`make_train_step` does.

    ``grad_comm`` picks the reduction: ``psum`` (flat all-reduce),
    ``hierarchical`` (:mod:`repro_torch.dist.collectives`) or ``int8``
    (the shared-scale int8 wire format with error feedback,
    :func:`repro_torch.dist.compress.compressed_psum_ef`): the optimizer
    state is then ``{"opt": adam, "ef": residual}``, the residual this
    rank's own (:func:`make_dp_opt_state`).

    The reference's semantics: each rank's mean cross entropy is weighted
    by its share of the global valid tokens (a rank without one counts
    0), so the CE term equals the plain step's under any label masking;
    the MoE load-balance loss is added as ``router_aux_coef * aux /
    n_rep`` (the standard data-parallel average of per-rank losses over
    local tokens).  Metrics: ``tokens`` summed over the ranks,
    ``aux_loss`` averaged, the others share-weighted and summed; then
    ``grad_norm`` of the reduced gradient.  A replica's noise comes from
    ``noise_for(seed * n_rep + replica)`` (one stream a (seed, replica)
    pair; at one replica the plain step's): the reference folds the
    replica index into ``PRNGKey(seed)``, which this matches in
    distribution, not in stream (torch generators are not threefry).
    """
    if grad_comm not in ("psum", "hierarchical", "int8"):
        raise ValueError(f"unknown grad_comm {grad_comm!r}")
    noise_for = noise_for or seeded_noise(model.device)
    axes = data_axes(mesh)
    pod_axis = "pod" if "pod" in axes else None
    n_rep = 1
    for ax in axes:
        n_rep *= C.axis_size(mesh, ax)
    rep = C.replica_index(mesh, axes)
    use_ef = grad_comm == "int8"

    def train_step(params, opt_state, batch, seed: int):
        inner = opt_state["opt"] if use_ef else opt_state
        n_valid = torch.sum(batch["labels"] >= 0).to(torch.float32)
        share = n_valid / torch.clamp_min(C.psum(n_valid, mesh, axes), 1.0)
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        _, metrics = model.loss(params, batch,
                                noise=noise_for(seed * n_rep + rep),
                                remat=remat)
        obj = share * metrics["loss"]
        if "aux_loss" in metrics:        # the encoder-decoder has no aux term
            obj = obj + model.cfg.router_aux_coef * metrics["aux_loss"] / n_rep
        grads = torch.autograd.grad(obj, leaves)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        del grads
        grads = optim.tree_map(lambda p: by_leaf[id(p)], params)
        del by_leaf
        if use_ef:
            grads, new_res = compress.compressed_psum_ef(
                grads, opt_state["ef"], mesh, axes)
        else:
            grads = C.grad_allreduce(grads, mesh, mode=grad_comm,
                                     data_axis="data", pod_axis=pod_axis)
        metrics = {k: (C.psum(v.detach(), mesh, axes) if k == "tokens"
                       else C.psum(v.detach(), mesh, axes) / n_rep
                       if k == "aux_loss"
                       else C.psum(v.detach() * share, mesh, axes))
                   for k, v in metrics.items()}
        metrics["grad_norm"] = optim.global_norm(grads)
        inner = optimizer.update_(grads, inner, params,
                                  norm=metrics["grad_norm"])
        if use_ef:
            return params, {"opt": inner, "ef": new_res}, metrics
        return params, inner, metrics

    return train_step


def make_dp_opt_state(optimizer: optim.Adam, params, *,
                      grad_comm: str = "gspmd"):
    """The optimizer state for a train step of ``grad_comm``: Adam's, and
    with ``int8`` beside it this rank's zero error-feedback residual
    (``{"opt": adam, "ef": residual}``, float32 leaves of the params'
    shapes).  The reference stacks every replica's residual on a leading
    dim sized by its mesh; a rank holds its own here, so no mesh is
    needed."""
    opt_state = optimizer.init(params)
    if grad_comm != "int8":
        return opt_state
    return {"opt": opt_state, "ef": compress.ef_init(params)}


def make_prefill_step(model) -> Callable:
    """``prefill_step(params, batch) -> (next_token (B, 1) int32, logits
    (B, 1, V))``: the prompt's forward (every key of ``batch`` but
    ``tokens`` is the modality input, as ``frames``), greedy."""
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        logits = model.prefill(params, tokens, extra or None)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    return prefill_step


def make_serve_step(model) -> Callable:
    """One decode step: ``serve_step(params, state, tokens (B, 1)) ->
    (greedy next token (B,) int32, new state)``."""
    def serve_step(params, state, tokens):
        logits, new_state = model.decode_step(params, state, tokens)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), \
            new_state

    return serve_step


def build_all(cfg, device=None):
    """(model, train_step, prefill_step, serve_step) for one config, the
    model on ``device`` (default ``cuda``)."""
    model = build(cfg, device)
    opt = make_optimizer(cfg)
    return (model, make_train_step(model, opt), make_prefill_step(model),
            make_serve_step(model))
