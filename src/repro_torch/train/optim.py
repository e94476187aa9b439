"""Adam, LR schedules and gradient utilities on trees of tensors.

The twin of the JAX package's ``repro/train/optim.py``, with its
arithmetic: a tree is a nested dict of float32 tensors (the classifier's
``{"lstm": {...}, "fc": {...}}``), the state mirrors it, and
:meth:`Adam.update` is a pure function ``(grads, state, params) ->
(new params, new state)``.  The step is the reference's float32
expression ``p - lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * p)`` with
``c = 1 - b ** count`` (AdamW's decoupled decay ``wd``), after the
reference's optional clip of the gradients to a global norm, not
``torch.optim.Adam``'s (which divides ``sqrt(v)`` by ``sqrt(c2)`` and
folds ``c1`` into the learning rate, a different rounding).  Its
multiply-adds are rounded once, as ``jax.jit`` compiles them on the CPU
(XLA contracts each into a fused multiply-add): ``m' = fma(b1, m,
(1-b1)*g)``, ``v' = fma(b2, v, (1-b2)*g*g)`` and ``p' = fma(-lr, step,
p)`` (:func:`~repro_torch.kernels.ref.fma_f32`).  The global norm sums in
torch's order, not XLA's: where the clip acts, the scale may differ from
the reference's by an ulp.  :meth:`Adam.update_` computes the same bits
in place, leaf by leaf and in chunks, for models whose optimizer state
fills most of the card.  The step count and the schedules' values are
0-dim tensors on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.kernels.ref import fma_f32


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of its shape): a
    tree is nested dicts and lists (the LM's per-layer list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class OptState(NamedTuple):
    count: torch.Tensor     # () int32
    mu: object              # tree like params
    nu: object              # tree like params


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam/AdamW.  ``lr`` may be a float or a schedule ``fn(step) ->
    lr``; ``weight_decay`` > 0 adds ``wd * p`` to the step; and
    ``grad_clip_norm`` > 0 clips the gradients to that global norm
    first (:func:`clip_by_global_norm`)."""

    lr: Union[Callable, float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0

    def init(self, params) -> OptState:
        zeros = lambda p: torch.zeros_like(p)
        return OptState(count=torch.zeros((), dtype=torch.int32),
                        mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    def _lr(self, count):
        if callable(self.lr):
            return self.lr(count)
        return self.lr

    def _constants(self, count):
        cf = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32), cf)
        c2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32), cf)
        return c1, c2, self._lr(count)

    def _mu(self, m, g):
        return fma_f32(_scalar(self.b1, m), m, (1 - self.b1) * g)

    def _nu(self, v, g):
        return fma_f32(_scalar(self.b2, v), v,
                       (1 - self.b2) * torch.square(g))

    def _param(self, p, m, v, c1, c2, lr):
        step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        if self.weight_decay > 0:
            step = step + self.weight_decay * p
        return fma_f32(-_scalar(lr, p), step, p)

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        count = state.count + 1
        if self.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        mu = tree_map(self._mu, state.mu, grads)
        nu = tree_map(self._nu, state.nu, grads)
        c1, c2, lr = self._constants(count)
        new_params = tree_map(
            lambda p, m, v: self._param(p, m, v, c1, c2, lr), params, mu, nu)
        return new_params, OptState(count=count, mu=mu, nu=nu)

    @torch.no_grad()
    def update_(self, grads, state: OptState, params,
                chunk: int = 1 << 24,
                norm: Optional[torch.Tensor] = None) -> OptState:
        """:meth:`update` in place: each leaf of ``params``, ``state.mu``
        and ``state.nu`` is overwritten ``chunk`` elements at a time, so
        the update needs no second copy of the model and its temporaries
        stay at a few chunks (``fma_f32`` works in float64).  Bitwise
        :meth:`update`'s result.  ``norm``, where the caller has it, is
        ``global_norm(grads)``, so the clip does not sum the gradients
        again.  Returns the new state, which holds the same ``mu`` and
        ``nu`` tensors."""
        count = state.count + 1
        scale = _clip_scale(grads, self.grad_clip_norm, norm) \
            if self.grad_clip_norm > 0 else None
        c1, c2, lr = self._constants(count)
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(grads)):
            pf, mf, vf, gf = (t.view(-1) for t in (p, m, v, g))
            for i in range(0, pf.numel(), chunk):
                sl = slice(i, i + chunk)
                gi = gf[sl] if scale is None \
                    else gf[sl] * scale.to(gf.dtype)
                mi, vi = self._mu(mf[sl], gi), self._nu(vf[sl], gi)
                pf[sl] = self._param(pf[sl], mi, vi, c1, c2, lr)
                mf[sl] = mi
                vf[sl] = vi
        return OptState(count=count, mu=state.mu, nu=state.nu)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a float or a 0-dim tensor) as a float32 0-dim tensor on
    ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in key order) of their squares' sums."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _clip_scale(tree, max_norm: float,
                norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    if norm is None:
        norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    scale = _clip_scale(tree, max_norm)
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
