"""Adam, LR schedules and gradient utilities on trees of tensors.

The twin of the JAX package's ``repro/train/optim.py``, with its
arithmetic: a tree is a nested dict of float32 tensors (the classifier's
``{"lstm": {...}, "fc": {...}}``), the state mirrors it, and
:meth:`Adam.update` is a pure function ``(grads, state, params) ->
(new params, new state)``.  The step is the reference's float32
expression ``p - lr * (m / c1) / (sqrt(v / c2) + eps)`` with
``c = 1 - b ** count``, not ``torch.optim.Adam``'s (which divides
``sqrt(v)`` by ``sqrt(c2)`` and folds ``c1`` into the learning rate, a
different rounding).  Its multiply-adds are rounded once, as ``jax.jit``
compiles them on the CPU (XLA contracts each into a fused multiply-add):
``m' = fma(b1, m, (1-b1)*g)``, ``v' = fma(b2, v, (1-b2)*g*g)`` and
``p' = fma(-lr, step, p)``
(:func:`~repro_torch.kernels.ref.fma_f32`).  The step count and the
schedules' values are 0-dim tensors on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Union

import torch

from repro_torch.kernels.ref import fma_f32


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of its shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


class OptState(NamedTuple):
    count: torch.Tensor     # () int32
    mu: object              # tree like params
    nu: object              # tree like params


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam. ``lr`` may be a float or a schedule ``fn(step) -> lr``.  The
    reference's weight decay and built-in clip are not ported: Alg. 1
    training uses neither (clip with :func:`clip_by_global_norm`)."""

    lr: Union[Callable, float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> OptState:
        zeros = lambda p: torch.zeros_like(p)
        return OptState(count=torch.zeros((), dtype=torch.int32),
                        mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    def _lr(self, count):
        if callable(self.lr):
            return self.lr(count)
        return self.lr

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: fma_f32(_scalar(b1, m), m, (1 - b1) * g),
                      state.mu, grads)
        nu = tree_map(lambda v, g: fma_f32(_scalar(b2, v), v,
                                           (1 - b2) * torch.square(g)),
                      state.nu, grads)
        cf = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)
        lr = self._lr(count)

        def upd(p, m, v):
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return fma_f32(-_scalar(lr, p), step, p)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, OptState(count=count, mu=mu, nu=nu)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a float or a 0-dim tensor) as a float32 0-dim tensor on
    ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in key order) of their squares' sums."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return fn


def wsd_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                 decay_frac: float = 0.2):
    """Warmup-stable-decay (the modern LM default)."""
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = peak_lr * (1.0 - prog * 0.9)
        mid = torch.where(step >= decay_start, decay,
                          torch.full_like(step, peak_lr))
        return torch.where(step < warmup_steps, warm, mid)

    return fn
