"""Step factories for the LM: the optimizer, the train step, the prefill
and serve steps.

The torch twin of the JAX package's ``repro/launch/steps.py``
(``make_optimizer``, ``make_train_step``, ``make_prefill_step``,
``make_serve_step``, ``build_all``).  The reference derives every
step's randomness from ``jax.random.PRNGKey(seed)``; here a step draws
from the :class:`NoiseSource` that ``noise_for(seed)`` returns, by
default a ``torch.Generator`` on the model's device seeded with ``seed``.
The data-parallel step with explicit gradient collectives
(``make_dp_train_step``) belongs to distribution (``ROADMAP.md`` queue A
item 6).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.crossbar import GeneratorNoise, NoiseSource
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
