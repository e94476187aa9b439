"""Batched serving engine: continuous batching over a fixed decode batch.

The scan-prefill slice of the JAX package's ``repro/serve/engine.py``,
with its semantics copied exactly:

* a fixed ``(max_batch, max_len)`` decode state allocated once;
* queued requests are admitted into free slots: each prompt minus its last
  token runs through ``decode_step`` on a batch-1 state
  (:meth:`ServingEngine._prefill_slot`), which is then copied into the
  slot, and the shared ``index`` becomes the maximum slot position
  (:meth:`ServingEngine._merge_slot`);
* one ``decode_step`` advances every slot a token (greedy argmax over the
  last logits); a request ends at ``max_new_tokens``, its EOS, or the end
  of the cache, and frees its slot at once.

Every decode step and every prefill position runs the model's kernels once
per layer on the ``cuda`` backend.  The decode state may hold any cache
layout the model makes (bf16/f32 K/V, or int8 codes with bfloat16
scales): admission copies every tensor of a slot's cache.  Only
``prefill="scan"`` with synchronous steps is ported: the bucketed, packed
and chunked prefill, the detokenize thread, device aging, recalibration,
fleets, checkpoints and observability raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_SERVING_ITEM = "ROADMAP.md queue A item 4 (serving)"
_LATER = {
    "prefill_buckets": "the bucketed prefill",
    "pack_prefill": "the packed prefill",
    "detok_thread": "the detokenize thread",
    "device": "device aging of the served weights",
    "recal": "the recalibration scheduler",
    "drain_before_rejit": "draining before a chip re-program",
    "external_maintenance": "fleet maintenance",
    "obs": "observability",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                    # -1: never
    # filled by the engine
    generated: Optional[List[int]] = None


class ServingEngine:
    """Continuous batching over ``max_batch`` slots of ``max_len`` cache
    positions, for a model with ``init_decode_state`` / ``decode_step``
    (:class:`repro_torch.nn.transformer.LM`)."""

    def __init__(self, model, params, *, max_batch: int, max_len: int,
                 prefill: str = "scan", **later):
        if prefill != "scan":
            raise NotImplementedError(
                f"prefill={prefill!r} is not ported yet (only 'scan'); "
                f"{_SERVING_ITEM} brings the bucketed path")
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"{_LATER[name]} ({name}=) is not ported yet; "
                    f"{_SERVING_ITEM} brings it")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = model.device
        self.state = model.init_decode_state(max_batch, max_len)
        self.slot_free = [True] * max_batch
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)     # next position
        self.slot_last = np.zeros(max_batch, np.int32)    # last token
        self.queue: List[Request] = []
        # work done and host-clock seconds spent, for run_offline's rates
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # -- model calls ------------------------------------------------------

    def _decode_all(self, params, state, tokens):
        """Advance every slot one token; returns (next tokens, state)."""
        logits, new_state = self.model.decode_step(params, state, tokens)
        return torch.argmax(logits[:, -1], dim=-1), new_state

    def _prefill_slot(self, params, state, tokens: torch.Tensor, *,
                      length: int):
        """Feed ``tokens[:length]`` through decode steps on a batch-1
        state, filling its cache (exact: it is the decode path)."""
        for t in range(length):
            _, state = self.model.decode_step(params, state,
                                              tokens[t].view(1, 1))
        self.prefill_steps += length
        return state

    # -- host-side scheduling -------------------------------------------

    def submit(self, req: Request):
        req.generated = []
        self.queue.append(req)

    def _admit(self):
        """Prefill queued requests into free slots."""
        for slot in range(self.max_batch):
            if not self.queue or not self.slot_free[slot]:
                continue
            req = self.queue.pop(0)
            mini_state = self.model.init_decode_state(1, self.max_len)
            if len(req.prompt) > 1:
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                         device=self.device)
                mini_state = self._prefill_slot(
                    self.params, mini_state, tokens,
                    length=len(req.prompt) - 1)
            self.slot_free[slot] = False
            self.slot_req[slot] = req
            # positions 0..len-2 are cached; the LAST prompt token decodes
            # in the shared batch step at position len-1
            self.slot_pos[slot] = len(req.prompt) - 1
            self.slot_last[slot] = int(req.prompt[-1])
            self._merge_slot(mini_state, slot)

    def _merge_slot(self, mini_state, slot: int):
        """Copy the single-request cache into batch slot ``slot``, every
        tensor of it (K and V, and for an int8 cache their scales); the
        shared index becomes the maximum slot position (the reference's
        documented simplification of per-slot indices)."""
        for big, small in zip(self.state["layers"], mini_state["layers"]):
            for name, t in big.items():
                t[slot:slot + 1].copy_(small[name])
        self.state["index"] = max(self.state["index"],
                                  int(self.slot_pos[slot]))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> Dict[int, int]:
        """One engine iteration: admit + decode.  Returns {uid: token}."""
        t0 = time.perf_counter()
        self._admit()
        self._sync()
        self.prefill_seconds += time.perf_counter() - t0
        active = [s for s in range(self.max_batch) if not self.slot_free[s]]
        if not active:
            return {}
        t0 = time.perf_counter()
        out = self._step_sync(active)
        self.decode_seconds += time.perf_counter() - t0
        return out

    def _step_sync(self, active) -> Dict[int, int]:
        """The synchronous decode step: dispatch, block on the host
        transfer, do the per-request bookkeeping inline."""
        tokens = torch.as_tensor(self.slot_last[:, None].astype(np.int64),
                                 device=self.device)
        next_tok, self.state = self._decode_all(self.params, self.state,
                                                tokens)
        self.decode_steps += 1
        next_np = next_tok.cpu().numpy()
        out = {}
        for s in active:
            req = self.slot_req[s]
            tok = int(next_np[s])
            req.generated.append(tok)
            out[req.uid] = tok
            self.slot_last[s] = tok
            self.slot_pos[s] += 1
            done = (len(req.generated) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.slot_pos[s] >= self.max_len - 1)
            if done:
                self.slot_free[s] = True
                self.slot_req[s] = None
        return out

    def run_to_completion(self, max_iters: int = 10_000) -> int:
        """Drain the queue; returns the number of tokens generated."""
        n = 0
        for _ in range(max_iters):
            if not self.queue and all(self.slot_free):
                break
            n += len(self.step())
        return n

    def run_offline(self, requests=None, max_iters: int = 100_000) -> dict:
        """Submit the whole burst up front and drain it.  Host-clock rates
        (each step ends on a device synchronize): tokens/s over the run,
        and ms per decode step and per prefill position."""
        for req in (requests or []):
            self.submit(req)
        steps0, pre0 = self.decode_steps, self.prefill_steps
        dsec0, psec0 = self.decode_seconds, self.prefill_seconds
        t0 = time.perf_counter()
        n = self.run_to_completion(max_iters=max_iters)
        dt = time.perf_counter() - t0
        steps = self.decode_steps - steps0
        pre = self.prefill_steps - pre0
        dsec = self.decode_seconds - dsec0
        psec = self.prefill_seconds - psec0
        return {"tokens": int(n), "seconds": float(dt),
                "tokens_per_s": float(n / dt) if dt > 0 else 0.0,
                "decode_steps": steps, "prefill_steps": pre,
                "decode_step_ms": 1e3 * dsec / steps if steps else 0.0,
                "prefill_step_ms": 1e3 * psec / pre if pre else 0.0}
