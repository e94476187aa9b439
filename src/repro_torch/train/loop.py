"""The LM training loop: steps, checkpoints, fault tolerance and metrics.

The torch twin of the JAX package's ``repro/train/loop.py``
(``TrainState``, ``grad_accum_step`` and ``Trainer``).  Each step takes
``pipeline.batch_at(step)`` and runs the train step with ``seed = step``
through a :class:`~repro_torch.ft.executor.RetryingExecutor`: a
``TransientFailure`` is retried, a ``WorkerFailure`` restores the latest
checkpoint and replays from its step.  ``Obs`` counts the steps
(``train.steps_total``), gauges ``train.loss`` and ``train.grad_norm``,
records ``train.step_ms`` as a histogram and opens a ``train_step`` span
around every step, as the reference's does.  With ``ckpt_dir`` a
:class:`~repro_torch.ckpt.CheckpointManager` (async, keep ``keep``)
saves ``{"params", "opt"}`` every ``ckpt_every`` steps and once more,
blocking, at the end; :meth:`Trainer.fit` resumes from the latest
checkpoint there (the reference's layout: either package resumes the
other's).  The port keeps each step's host milliseconds in ``step_ms``
besides the histogram, and writes its log lines through ``log``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.ft.executor import RetryingExecutor, StragglerPolicy
from repro_torch.train import optim


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any


def split_micro(batch: Dict[str, torch.Tensor], n_micro: int
                ) -> Dict[str, torch.Tensor]:
    """A batch of B rows as ``n_micro`` microbatches of B / n_micro rows,
    stacked on a new leading axis (``grad_accum_step``'s input)."""
    return {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
            for k, v in batch.items()}


def grad_accum_step(model, optimizer: optim.Adam, n_micro: int, *,
                    noise_for: Optional[Callable] = None) -> Callable:
    """``stepped(params, opt_state, micro_batches, seed) -> (params,
    opt_state, metrics)``: the gradients averaged over ``n_micro``
    microbatches, then one optimizer update (in place, as
    ``launch.steps.make_train_step``'s).  ``micro_batches`` holds each
    batch key stacked on a leading axis of ``n_micro`` (:func:`split_micro`).

    Microbatch ``idx`` draws its ramp noise from ``noise_for(seed + idx)``
    (the reference's ``PRNGKey(seed + idx)``; default a generator on the
    model's device) and recomputes each layer in the backward
    (``remat=True``), as the reference does.  One microbatch's graph is
    alive at a time, and its gradients never exist apart from the sum:
    the backward adds each leaf's gradient in place into the leaf's
    ``.grad`` as it is made, in the reference's order ``(g0 + g1) + ...``
    (the reference starts from a tree of zeros, and ``0 + g0`` differs
    from ``g0`` only in the sign of a zero, which nothing downstream
    sees).  The sum is then scaled by ``1 / n_micro`` rounded to float32,
    as jitted XLA divides by a constant, and the ``.grad`` slots are
    cleared.  ``metrics``: ``loss``,
    the mean of the microbatches' ``metrics["loss"]`` (a MoE's aux loss
    enters the gradient, not the reported loss), and ``grad_norm``, the
    global norm of the averaged gradients, which the update's clip reuses.
    """
    if noise_for is None:
        from repro_torch.launch.steps import seeded_noise

        noise_for = seeded_noise(model.device)
    scale = float(np.float32(1.0 / n_micro))

    def stepped(params, opt_state, micro_batches, seed: int):
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for idx in range(n_micro):
            mb = {k: v[idx] for k, v in micro_batches.items()}
            total, metrics = model.loss(params, mb,
                                        noise=noise_for(seed + idx),
                                        remat=True)
            total.backward(inputs=leaves)
            loss_sum = loss_sum + metrics["loss"].detach()
            del total, metrics
        grads = optim.tree_map(lambda p: p.grad.mul_(scale), params)
        for p in leaves:
            p.grad = None
        metrics = {"loss": loss_sum * scale,
                   "grad_norm": optim.global_norm(grads)}
        opt_state = optimizer.update_(grads, opt_state, params,
                                      norm=metrics["grad_norm"])
        return params, opt_state, metrics

    return stepped


class Trainer:
    """Runs ``train_step`` over ``pipeline``'s batches.  ``put_batch``
    turns a numpy batch into the step's tensors (on the model's device).

    The step updates the params in place, so a failure raised after the
    optimizer's update would replay on params that have already moved: a
    ``TransientFailure`` must be raised before the update (a
    ``WorkerFailure`` restores the checkpoint's tensors in place first).
    ``history`` keeps a step's metrics when ``step % log_every == 0`` or
    it is the last step, as the reference's."""

    def __init__(self, model, optimizer, train_step: Callable, pipeline,
                 *, ckpt_dir: Optional[str] = None, ckpt_every: int = 200,
                 keep: int = 3, log_every: int = 10,
                 put_batch: Optional[Callable] = None, obs=None, log=print):
        from repro_torch.obs import Obs

        self.obs = obs if obs is not None else Obs(trace=False)
        self._m_steps = self.obs.counter("train.steps_total")
        self._m_loss = self.obs.gauge("train.loss")
        self._m_grad_norm = self.obs.gauge("train.grad_norm")
        self._m_step_ms = self.obs.histogram("train.step_ms")
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep,
                                       save_interval=ckpt_every)
                     if ckpt_dir else None)
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.pipeline = pipeline
        self.put_batch = put_batch or (lambda b: b)
        self.log_every = log_every
        self.log = log
        self.history: List[Dict[str, float]] = []
        self.step_ms: List[float] = []
        self._template: Optional[TrainState] = None
        self._last_metrics: Dict[str, float] = {}

        def _step(state: TrainState, step: int) -> TrainState:
            batch = self.put_batch(self.pipeline.batch_at(step))
            # looked up at call time: launch.train swaps it to count
            # kernel launches
            params, opt_state, metrics = self.train_step(
                state.params, state.opt_state, batch, step)
            # reading the metrics waits for the step's end on the device
            self._last_metrics = {k: float(v) for k, v in metrics.items()}
            return TrainState(params, opt_state)

        def _restore(step: int):
            # the save in flight first, so the restore sees every step
            # that should_save promised
            self.ckpt.wait()
            return self._restore_into(self._template)

        self.executor = RetryingExecutor(
            _step, restore_fn=_restore if ckpt_dir else None,
            straggler=StragglerPolicy())

    def _ckpt_tree(self, state: TrainState) -> Dict[str, Any]:
        return {"params": state.params, "opt": state.opt_state}

    def _restore_into(self, state: TrainState):
        """``(state, step)`` of the latest checkpoint, loaded into
        ``state``'s tensors in place (the card holds one copy of the
        params and moments)."""
        restored, step, _ = self.ckpt.restore(self._ckpt_tree(state))
        return TrainState(restored["params"], restored["opt"]), step

    def fit(self, state: TrainState, n_steps: int,
            start_step: int = 0) -> TrainState:
        """Steps ``start_step`` (or the latest checkpoint's) to
        ``n_steps``."""
        self._template = state
        step = start_step
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, step = self._restore_into(state)
            if self.log is not None:
                self.log(f"[trainer] resumed from step {step}")
        t0 = time.time()
        while step < n_steps:
            ts = time.perf_counter()
            self.obs.set_step(step)
            with self.obs.span("train_step"):
                state, step = self.executor.run_step(state, step)
            ms = 1e3 * (time.perf_counter() - ts)
            self.step_ms.append(ms)
            self._m_steps.inc()
            self._m_step_ms.record(ms)
            lm = self._last_metrics
            if "loss" in lm:
                self._m_loss.set(lm["loss"])
            if "grad_norm" in lm:
                self._m_grad_norm.set(lm["grad_norm"])
            if step % self.log_every == 0 or step == n_steps:
                m = dict(lm)
                m["step"] = step
                m["wall_s"] = round(time.time() - t0, 2)
                self.history.append(m)
                if self.log is not None:
                    self.log(f"[trainer] step {step:5d} loss "
                             f"{m.get('loss', float('nan')):.4f} "
                             f"({m['wall_s']}s)")
            if self.ckpt is not None and self.ckpt.should_save(step):
                self.ckpt.save(step, self._ckpt_tree(state))
        if self.ckpt is not None:
            self.ckpt.save(n_steps, self._ckpt_tree(state), blocking=True)
        return state


def to_device_batch(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}
