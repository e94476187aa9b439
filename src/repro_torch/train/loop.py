"""The LM training loop: steps, logging and the gradient norm.

The torch twin of the JAX package's ``repro/train/loop.py`` (``TrainState``
and ``Trainer``): each step takes ``pipeline.batch_at(step)``, runs the
train step with ``seed = step`` and appends every step's metrics to
``history`` (the reference's ``log_every=1``).  Left out, each with its
queue item in ``ROADMAP.md``: checkpoints and resuming from a step
(``ckpt_dir=`` raises; queue A item 4), the retrying executor and
straggler policy (queue A item 6), the ``Obs`` counters and spans (queue
A item 4) and a logging interval; the loop also keeps each step's host
milliseconds in ``step_ms``, where the reference records a histogram.
``grad_accum_step`` is not ported (queue A item 3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any


class Trainer:
    """Runs ``train_step`` over ``pipeline``'s batches.  ``put_batch``
    turns a numpy batch into the step's tensors (on the model's device)."""

    def __init__(self, model, optimizer, train_step: Callable, pipeline,
                 *, ckpt_dir: Optional[str] = None,
                 put_batch: Optional[Callable] = None, log=print):
        if ckpt_dir is not None:
            raise NotImplementedError(
                "checkpoints are not ported yet; ROADMAP.md queue A item 4 "
                "(ckpt/checkpoint.py) brings them")
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.pipeline = pipeline
        self.put_batch = put_batch or (lambda b: b)
        self.log = log
        self.history: List[Dict[str, float]] = []
        self.step_ms: List[float] = []

    def fit(self, state: TrainState, n_steps: int) -> TrainState:
        t0 = time.time()
        for step in range(n_steps):
            ts = time.perf_counter()
            batch = self.put_batch(self.pipeline.batch_at(step))
            params, opt_state, metrics = self.train_step(
                state.params, state.opt_state, batch, step)
            state = TrainState(params, opt_state)
            # reading the metrics waits for the step's end on the device
            m = {k: float(v) for k, v in metrics.items()}
            self.step_ms.append(1e3 * (time.perf_counter() - ts))
            m["step"] = step + 1
            m["wall_s"] = round(time.time() - t0, 2)
            self.history.append(m)
            if self.log is not None:
                self.log(f"[trainer] step {step + 1:5d} loss "
                         f"{m.get('loss', float('nan')):.4f} "
                         f"({m['wall_s']}s)")
        return state


def to_device_batch(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}
