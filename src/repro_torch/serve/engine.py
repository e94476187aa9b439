"""Batched serving engine: continuous batching over a fixed decode batch.

The JAX package's ``repro/serve/engine.py`` up to its lifecycle, with its
semantics copied exactly:

* a fixed ``(max_batch, max_len)`` decode state allocated once;
* queued requests are admitted into free slots; each prompt minus its
  last token is prefilled into the slot's cache, and the shared ``index``
  becomes the maximum slot position;
* one ``decode_step`` advances every slot a token (greedy argmax over the
  last logits); a request ends at ``max_new_tokens``, its EOS, or the end
  of the cache, and frees its slot at once.

Two prefill paths fill the same caches:

* ``prefill="scan"`` (default): each prompt runs through ``decode_step``
  on a batch-1 state (:meth:`ServingEngine._prefill_slot`), which is then
  copied into its slot (:meth:`ServingEngine._merge_slot`).
* ``prefill="bucketed"``: the prefill length is rounded up to one of the
  ``prefill_buckets`` (powers of two up to ``max_len - 1`` by default) and
  run as that many masked decode steps (:func:`repro_torch.nn.model.
  prefill_cache`).  The reference compiles one executable per bucket; in
  eager PyTorch a bucket is the chunk schedule, kept so that chunk
  boundaries and kernel launches are the reference's.  With
  ``pack_prefill=True`` one call carries the whole admission wave (P =
  ``max_batch`` rows, each masked to its own length) and the rows are
  scattered into their slots (:meth:`ServingEngine._scatter_rows`).  A
  prompt longer than the largest bucket runs chunked: repeated calls
  carrying the state, the shared ``index`` keeping the cache positions.
  Each wave starts from a fresh pack state: the caches are written in
  place, so the reference's never-mutated template cannot be shared.

Token streams are the scan path's on every path.  Unpacked, the caches
are bitwise the scan path's; packed, the gate and attention see P rows
at once, and a row computed in a batch of P is not bitwise that row
computed alone (the reference differs from its own scan path by ~1e-6
there), so the packed caches agree within float32 rounding.

``detok_thread=True`` moves the wait for each step's tokens (copied
without blocking to pinned host memory) and the per-request bookkeeping
onto a background thread (:class:`_DetokWorker`): the next step reads a
device-side last-token
vector, results lag up to one :meth:`ServingEngine.step`, EOS is reaped
one step late and the stream truncated exactly as the synchronous path
does; :meth:`ServingEngine.detok_flush` joins the backlog.

``device=``: a :class:`~repro_torch.core.device.DeviceModel` whose build
stage ages the served weights at construction, per crossbar tile, as the
reference ages its stacked params (bitwise the reference engine's
``params`` after ``convert.lm_params_from_jax``).  The deployment (params
as served, decode state, slot arrays, served ramps and banks, requests)
checkpoints with :meth:`ServingEngine.save` (schema 2) and resumes with
:meth:`ServingEngine.restore`, into any prefill or detok mode.

Every decode step and every prefill position runs the model's kernels once
per layer on the ``cuda`` backend.  Not ported, each raising
``NotImplementedError`` naming its ``ROADMAP.md`` item: the
re-calibration scheduler (``recal=``, ``drain_before_rejit=``), fleet
maintenance (``external_maintenance=``) and observability (``obs=``).
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (load_checkpoint, read_metadata,
                                         save_checkpoint)
from repro_torch.core.device import device_from_dict
from repro_torch.serve.lifecycle import analog_activations

_LATER = {
    "recal": "the re-calibration scheduler; ROADMAP.md queue A item 4 "
             "(serving: serve/lifecycle.py)",
    "drain_before_rejit": "draining before a chip re-program; ROADMAP.md "
                          "queue A item 4 (serving: serve/lifecycle.py)",
    "external_maintenance": "fleet maintenance; ROADMAP.md queue A item 4 "
                            "(serving: serve/fleet.py)",
    "obs": "observability; ROADMAP.md queue A item 4 (serving: obs/ with "
           "core/hwcost.py)",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                    # -1: never
    # filled by the engine
    generated: Optional[List[int]] = None

    def to_dict(self) -> dict:
        return {"uid": self.uid, "prompt": np.asarray(self.prompt).tolist(),
                "max_new_tokens": self.max_new_tokens, "eos_id": self.eos_id,
                "generated": list(self.generated or [])}

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(uid=d["uid"],
                   prompt=np.asarray(d["prompt"], np.int32),
                   max_new_tokens=d["max_new_tokens"], eos_id=d["eos_id"],
                   generated=list(d["generated"]))


class _DetokWorker:
    """Background detokenize thread.

    The engine hands it each decode step's device token vector and a
    snapshot of the active ``(slot, request)`` pairs.  :meth:`put`, on
    the dispatch thread, queues the device-to-host copy into a pinned
    host buffer behind the step and records an event after it; the
    worker waits on that event alone (not on steps queued since) and does
    the bookkeeping (append to ``generated``, EOS), so the next step
    launches without waiting for the previous step's host work.  One FIFO
    queue and one worker keep the order, so the streams are what the
    synchronous path appends; EOS is seen one step late, and the worker
    stops appending past it so the stream is truncated as the synchronous
    path truncates it.
    """

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()
        self._results: _queue.Queue = _queue.Queue()
        self._lock = threading.Lock()
        self._eos: List[Tuple[int, int]] = []      # (slot, uid)
        self._thread = threading.Thread(
            target=self._loop, name="serve-detok", daemon=True)
        self._thread.start()

    def put(self, next_tok: torch.Tensor, snapshot) -> None:
        """Enqueue one decode step's tokens + active-slot snapshot; a CUDA
        vector's copy to pinned host memory is queued here, behind the
        step, and its end marked by an event."""
        done = None
        if next_tok.is_cuda:
            host = torch.empty(next_tok.shape, dtype=next_tok.dtype,
                               pin_memory=True)
            host.copy_(next_tok, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            next_tok = host
        self._q.put((next_tok, done, snapshot))

    def _loop(self) -> None:
        while True:
            toks, done, snapshot = self._q.get()
            if done is not None:
                done.synchronize()                 # this step's copy only
            toks = toks.numpy()
            out = {}
            for slot, req in snapshot:
                if getattr(req, "_eos_seen", False):
                    continue                       # truncate past EOS
                tok = int(toks[slot])
                req.generated.append(tok)
                out[req.uid] = tok
                if req.eos_id >= 0 and tok == req.eos_id:
                    req._eos_seen = True
                    with self._lock:
                        self._eos.append((slot, req.uid))
            self._results.put(out)
            self._q.task_done()

    def take_eos(self) -> List[Tuple[int, int]]:
        """Slots whose request hit EOS since the last call."""
        with self._lock:
            out, self._eos = self._eos, []
        return out

    def pop_one(self) -> Dict[int, int]:
        """At most one landed step batch ({} if none yet)."""
        try:
            return self._results.get_nowait()
        except _queue.Empty:
            return {}

    def flush(self) -> List[Dict[int, int]]:
        """Block until the backlog is processed; the landed batches."""
        self._q.join()
        out = []
        while True:
            try:
                out.append(self._results.get_nowait())
            except _queue.Empty:
                return out


class ServingEngine:
    """Continuous batching over ``max_batch`` slots of ``max_len`` cache
    positions, for a model with ``init_decode_state`` / ``decode_step`` /
    ``prefill_cache`` (:class:`repro_torch.nn.transformer.LM`); the knobs
    are the reference's (module docstring)."""

    SCHEMA = 2          # the deployment checkpoint schema written and read

    def __init__(self, model, params, *, max_batch: int, max_len: int,
                 device=None, prefill: str = "scan", prefill_buckets=None,
                 pack_prefill: bool = False, detok_thread: bool = False,
                 **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"{name}= is not ported yet: {_LATER[name]} brings it")
        if prefill not in ("scan", "bucketed"):
            raise ValueError(
                f"prefill must be 'scan' or 'bucketed', got {prefill!r}")
        if prefill != "bucketed" and (pack_prefill
                                      or prefill_buckets is not None):
            raise ValueError(
                "pack_prefill / prefill_buckets require prefill='bucketed'")
        self.device = device
        self._acts = analog_activations(model)
        if device is not None and device.has_build_stage:
            params = device.age_params(params, stacked="layers")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.dev = model.device
        self.state = model.init_decode_state(max_batch, max_len)
        self.slot_free = [True] * max_batch
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)     # next position
        self.slot_last = np.zeros(max_batch, np.int32)    # last token
        self.queue: List[Request] = []
        self.prefill_mode = prefill
        self.pack_prefill = bool(pack_prefill)
        self._pack_rows = max_batch if pack_prefill else 1
        if prefill == "bucketed":
            buckets = tuple(int(b) for b in (
                prefill_buckets if prefill_buckets is not None
                else self._default_buckets(max_len)))
            if not buckets or any(b <= 0 for b in buckets) \
                    or list(buckets) != sorted(set(buckets)):
                raise ValueError(
                    f"prefill_buckets must be strictly increasing positive "
                    f"lengths, got {buckets}")
            self.prefill_buckets: tuple = buckets
        else:
            self.prefill_buckets = ()
        # detokenize thread: per-slot token counters replace
        # len(generated) for the done check (the worker owns `generated`),
        # and the decode input is a device-side last-token vector
        self._slot_ntok = np.zeros(max_batch, np.int64)
        self._detok = _DetokWorker() if detok_thread else None
        self._slot_last_dev = self._to_dev(self.slot_last.astype(np.int64)) \
            if detok_thread else None
        # work done and host-clock seconds spent, for run_offline's rates:
        # prefill_steps counts the decode steps the prefill ran (bucket
        # widths on the bucketed path), prefill_waves its admission calls
        self.prefill_steps = 0
        self.prefill_waves = 0
        self.decode_steps = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.buckets_called: List[int] = []

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.dev.type == "cuda":
            return t.pin_memory().to(self.dev, non_blocking=True)
        return t

    # -- bucketed prefill -------------------------------------------------

    @staticmethod
    def _default_buckets(max_len: int) -> tuple:
        """Power-of-two prefill lengths 8, 16, ... capped by the longest
        legal prefill (``max_len - 1``), which ends the ladder so prompts
        that fit never need chunking."""
        top = max(max_len - 1, 1)
        out, b = [], 8
        while b < top:
            out.append(b)
            b *= 2
        out.append(top)
        return tuple(out)

    def _bucket_for(self, length: int) -> int:
        """Smallest bucket covering ``length`` (the largest if none does:
        the caller then chunks)."""
        for b in self.prefill_buckets:
            if b >= length:
                return b
        return self.prefill_buckets[-1]

    def warmup(self) -> dict:
        """Run every prefill bucket once and one decode step, each on a
        throwaway state: this builds the kernels and cuBLAS's handles
        before traffic arrives and advances no engine state."""
        out = {"prefill_buckets": [], "decode": True}
        P = self._pack_rows
        for b in self.prefill_buckets:
            self.model.prefill_cache(
                self.params, self.model.init_decode_state(P, self.max_len),
                torch.zeros((P, b), dtype=torch.int64, device=self.dev),
                np.zeros(P, np.int64))
            out["prefill_buckets"].append(b)
        self._decode_all(
            self.params,
            self.model.init_decode_state(self.max_batch, self.max_len),
            torch.zeros((self.max_batch, 1), dtype=torch.int64,
                        device=self.dev))
        self._sync()
        return out

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
        admits = []
        for slot in range(self.max_batch):
            if not self.queue or not self.slot_free[slot]:
                continue
            admits.append((slot, self.queue.pop(0)))
        if not admits:
            return
        if self.prefill_mode == "bucketed":
            self._admit_bucketed(admits)
            return
        for slot, req in admits:
            mini_state = self.model.init_decode_state(1, self.max_len)
            if len(req.prompt) > 1:
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                         device=self.dev)
                mini_state = self._prefill_slot(
                    self.params, mini_state, tokens,
                    length=len(req.prompt) - 1)
                self.prefill_waves += 1
            self._bookkeep_admit(slot, req)
            self._merge_slot(mini_state, slot)

    def _bookkeep_admit(self, slot: int, req: Request):
        self.slot_free[slot] = False
        self.slot_req[slot] = req
        # positions 0..len-2 are cached; the LAST prompt token decodes
        # in the shared batch step at position len-1
        self.slot_pos[slot] = len(req.prompt) - 1
        self._slot_ntok[slot] = len(req.generated or [])
        self._set_slot_last(slot, int(req.prompt[-1]))

    def _set_slot_last(self, slot: int, tok: int):
        self.slot_last[slot] = tok
        if self._detok is not None:
            self._slot_last_dev[slot] = tok

    def _admit_bucketed(self, admits):
        """Bucketed admission: round the wave's longest prefill up to a
        bucket and run the wave through it (packed: all rows in one call;
        unpacked: one call a request), chunk with repeated largest-bucket
        calls where the prompt is longer than every bucket, then scatter
        the rows into their slots."""
        groups = [admits] if self.pack_prefill else [[a] for a in admits]
        P = self._pack_rows
        for group in groups:
            lens = [len(req.prompt) - 1 for _, req in group]
            state = self.model.init_decode_state(P, self.max_len)
            l_max = max(lens)
            if l_max > 0:
                toks = np.zeros((P, l_max), np.int64)
                vlen = np.zeros((P,), np.int64)
                for row, (_, req) in enumerate(group):
                    toks[row, :lens[row]] = np.asarray(req.prompt[:lens[row]])
                    vlen[row] = lens[row]
                pos = 0
                while pos < l_max:
                    bucket = self._bucket_for(l_max - pos)
                    chunk = np.zeros((P, bucket), np.int64)
                    width = min(bucket, l_max - pos)
                    chunk[:, :width] = toks[:, pos:pos + width]
                    # the state's shared index carries the global position
                    # between chunks
                    state = self.model.prefill_cache(
                        self.params, state, self._to_dev(chunk), vlen)
                    self.buckets_called.append(bucket)
                    self.prefill_steps += bucket
                    pos += bucket
                self.prefill_waves += 1
            for slot, req in group:
                self._bookkeep_admit(slot, req)
            self._scatter_rows(state, [(row, slot) for row, (slot, _)
                                       in enumerate(group)])
            # global index = max over the admitted slots, as _merge_slot
            self.state["index"] = max(
                self.state["index"],
                int(max(self.slot_pos[slot] for slot, _ in group)))

    def _scatter_rows(self, mini, assign):
        """Copy pack rows into their batch slots (the whole wave's
        :meth:`_merge_slot`): per batched leaf, the assigned rows land at
        the assigned slots; the other slots keep their state bit for
        bit."""
        rows = torch.as_tensor([r for r, _ in assign], device=self.dev)
        slots = torch.as_tensor([s for _, s in assign], device=self.dev)
        for big, small in zip(self.state["layers"], mini["layers"]):
            for name, t in big.items():
                t[slots] = small[name][rows]

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
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def step(self) -> Dict[int, int]:
        """One engine iteration: admit + decode.  Returns {uid: token}.

        With ``detok_thread`` the returned batch is one that LANDED from
        an earlier step (at most one step of lag; {} while the first step
        is still in flight); :meth:`detok_flush` joins the backlog.
        """
        if self._detok is not None:
            self._reap_detok_eos()
        t0 = time.perf_counter()
        waves = self.prefill_waves
        self._admit()
        if self.prefill_waves != waves:
            self._sync()
            self.prefill_seconds += time.perf_counter() - t0
        active = [s for s in range(self.max_batch) if not self.slot_free[s]]
        if not active:
            return self._detok.pop_one() if self._detok is not None else {}
        t0 = time.perf_counter()
        out = self._step_detok(active) if self._detok is not None \
            else self._step_sync(active)
        self.decode_seconds += time.perf_counter() - t0
        return out

    def _step_sync(self, active) -> Dict[int, int]:
        """The synchronous decode step: dispatch, block on the host
        transfer, do the per-request bookkeeping inline."""
        tokens = torch.as_tensor(self.slot_last[:, None].astype(np.int64),
                                 device=self.dev)
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
            self._slot_ntok[s] += 1
            done = (len(req.generated) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.slot_pos[s] >= self.max_len - 1)
            if done:
                self.slot_free[s] = True
                self.slot_req[s] = None
        return out

    def _step_detok(self, active) -> Dict[int, int]:
        """The pipelined decode step: dispatch against the device-side
        last-token vector (no host sync), hand the result to the worker,
        and return whatever batch already landed.  The done-by-count
        check runs on host counters; a slot whose request hit EOS decodes
        one more token (which the worker drops) and is reaped at the top
        of the next step."""
        next_tok, self.state = self._decode_all(
            self.params, self.state, self._slot_last_dev[:, None])
        self.decode_steps += 1
        mask = np.zeros(self.max_batch, bool)
        mask[active] = True
        self._slot_last_dev = torch.where(self._to_dev(mask), next_tok,
                                          self._slot_last_dev)
        self._detok.put(next_tok, [(s, self.slot_req[s]) for s in active])
        for s in active:
            self.slot_pos[s] += 1
            self._slot_ntok[s] += 1
            if (self._slot_ntok[s] >= self.slot_req[s].max_new_tokens
                    or self.slot_pos[s] >= self.max_len - 1):
                # the worker still holds the request; its stream finishes
                # landing asynchronously
                self.slot_free[s] = True
                self.slot_req[s] = None
        return self._detok.pop_one()

    def _reap_detok_eos(self):
        """Free the slots whose request hit EOS (seen by the worker, one
        step after the synchronous path would)."""
        for slot, uid in self._detok.take_eos():
            req = self.slot_req[slot]
            if req is not None and req.uid == uid:
                self.slot_free[slot] = True
                self.slot_req[slot] = None

    def detok_flush(self) -> List[Dict[int, int]]:
        """Join the detokenize backlog (no-op without the thread): block
        until every handed-off step has landed, re-sync the host
        last-token mirror, reap any EOS that landed, and return the
        landed step batches."""
        if self._detok is None:
            return []
        batches = self._detok.flush()
        self.slot_last = self._slot_last_dev.cpu().numpy().astype(np.int32)
        self._reap_detok_eos()
        return batches

    def run_to_completion(self, max_iters: int = 10_000) -> int:
        """Drain the queue; returns the number of tokens generated."""
        n = 0
        for _ in range(max_iters):
            if not self.queue and all(self.slot_free):
                break
            n += len(self.step())
        # the last steps are still landing on the detokenize thread
        n += sum(len(batch) for batch in self.detok_flush())
        return n

    def run_offline(self, requests=None, max_iters: int = 100_000) -> dict:
        """Submit the whole burst up front and drain it.  Host-clock rates
        (a prefill wave ends on a device synchronize; so does a
        synchronous decode step, while with the detokenize thread a decode
        step's time is its dispatch): tokens/s over the run, ms per decode
        step, per prefill position and per prefill wave."""
        for req in (requests or []):
            self.submit(req)
        steps0, pre0 = self.decode_steps, self.prefill_steps
        waves0, nb0 = self.prefill_waves, len(self.buckets_called)
        dsec0, psec0 = self.decode_seconds, self.prefill_seconds
        t0 = time.perf_counter()
        n = self.run_to_completion(max_iters=max_iters)
        dt = time.perf_counter() - t0
        steps = self.decode_steps - steps0
        pre = self.prefill_steps - pre0
        waves = self.prefill_waves - waves0
        dsec = self.decode_seconds - dsec0
        psec = self.prefill_seconds - psec0
        return {"tokens": int(n), "seconds": float(dt),
                "tokens_per_s": float(n / dt) if dt > 0 else 0.0,
                "decode_steps": steps, "prefill_steps": pre,
                "prefill_waves": waves,
                "prefill_buckets_called": self.buckets_called[nb0:],
                "decode_step_ms": 1e3 * dsec / steps if steps else 0.0,
                "prefill_step_ms": 1e3 * psec / pre if pre else 0.0,
                "prefill_wave_ms": 1e3 * psec / waves if waves else 0.0}

    # -- checkpoint / restore ---------------------------------------------

    def _ckpt_tree(self):
        """The array state of the deployment (its structure must be the
        same at save and restore).  The reference's ``pristine`` params
        are stored only with a scheduler, and its ``noise_key`` feeds read
        noise that the LM's decode step never draws: neither is here."""
        return {
            "params": self.params,                       # aged, as served
            "state": {"index": torch.tensor(self.state["index"],
                                            dtype=torch.int32),
                      "layers": self.state["layers"]},
            "slot_pos": np.asarray(self.slot_pos),
            "slot_last": np.asarray(self.slot_last),
            "slot_free": np.asarray(self.slot_free, np.bool_),
            # the served comparator thresholds (float64), and the banked
            # (n_col_tiles, P) layout per realized width (without a
            # scheduler nothing re-programs them between save points)
            "ramps": {name: np.asarray(act.ramp.thresholds)
                      for name, act in self._acts.items()},
            "ramp_banks": {
                name: {f"w{width}": bank.thresholds_f64
                       for width, bank in sorted(act.banks().items())}
                for name, act in self._acts.items() if act.banks()},
        }

    def save(self, root: str, step: int) -> str:
        """Atomic full-deployment checkpoint; returns the directory.

        The metadata is the reference's schema 2: the engine's geometry,
        the device model, the bank inventory, the lifecycle fields (at
        their values without a scheduler), the in-flight requests and
        the queue; ``scheduler`` is None.  The reference's ``obs`` block
        is left out (``ROADMAP.md`` queue A item 4)."""
        # land the detokenize backlog first: `generated` and the host
        # last-token mirror must be caught up before they are written
        self.detok_flush()
        meta = {
            "schema": self.SCHEMA,
            "engine": {"max_batch": self.max_batch, "max_len": self.max_len},
            "device": None if self.device is None else self.device.to_dict(),
            "scheduler": None,
            "banks": {name: sorted(act.banks())
                      for name, act in self._acts.items() if act.banks()},
            "lifecycle": {"weight_gen": 0, "weight_prog_age_s": 0.0,
                          "rejit_pending": False, "maint_pending": False,
                          "refresh_ord": 0, "tile_gens": {}},
            "requests": {
                "slots": [None if r is None else r.to_dict()
                          for r in self.slot_req],
                "queue": [r.to_dict() for r in self.queue],
            },
        }
        return save_checkpoint(root, step, self._ckpt_tree(), metadata=meta)

    @classmethod
    def restore(cls, model, root: str, *, step: Optional[int] = None,
                params_like=None, prefill: str = "scan",
                prefill_buckets=None, pack_prefill: bool = False,
                detok_thread: bool = False, **later) -> "ServingEngine":
        """Resume a checkpointed deployment: same chip, same next token,
        in any prefill or detok mode (the modes share one state layout).

        ``params_like``: a tree of the model's params structure, whose
        tensors the checkpoint's params overwrite in place (default
        ``model.init`` from seed 0), so the card never holds two copies
        of the weights.  Params, decode caches, slot arrays, requests,
        the queue and the served ramps and banks all come from the
        checkpoint, on the model's device.  A checkpoint written with a re-calibration scheduler
        raises: the scheduler is not ported (``ROADMAP.md`` queue A item
        4)."""
        step, meta = read_metadata(root, step=step)
        if "engine" not in meta:
            hint = ("this is a fleet manifest — the fleet engine is "
                    "ROADMAP.md queue A item 4's next slice"
                    if isinstance(meta, dict) and "fleet" in meta else
                    "train checkpoints restore via repro_torch.ckpt "
                    "directly")
            raise ValueError(
                f"checkpoint at {root!r} (step {step}) is not a "
                f"ServingEngine deployment checkpoint (no 'engine' "
                f"metadata); {hint}")
        schema = int(meta.get("schema", 1))
        if schema > cls.SCHEMA:
            raise ValueError(
                f"deployment checkpoint schema {schema} is newer than this "
                f"build understands (<= {cls.SCHEMA}); upgrade "
                "repro_torch, or re-serve and re-checkpoint with this "
                "version")
        if schema < 2:
            # schema 1: no threshold banks, no lifecycle bookkeeping
            meta.setdefault("banks", {})
            meta.setdefault("lifecycle", {})
        if meta.get("scheduler") is not None:
            raise NotImplementedError(
                "this deployment was checkpointed with a re-calibration "
                "scheduler; " + _LATER["recal"] + " brings its restore")
        if params_like is None:
            gen = torch.Generator(device=model.device)
            gen.manual_seed(0)
            params_like = model.init(gen)
        eng = cls(model, params_like,
                  max_batch=meta["engine"]["max_batch"],
                  max_len=meta["engine"]["max_len"],
                  prefill=prefill, prefill_buckets=prefill_buckets,
                  pack_prefill=pack_prefill, detok_thread=detok_thread,
                  **later)
        # the checkpointed bank inventory must be this model's, in both
        # directions, before the template's leaf paths can line up
        for name, widths in meta["banks"].items():
            act = eng._acts.get(name)
            if act is None:
                raise ValueError(
                    f"checkpoint carries threshold banks for activation "
                    f"{name!r} but the model has no such NL-ADC "
                    f"activation; have {sorted(eng._acts)}")
            for width in widths:
                if act.bank_for(int(width)) is None:
                    raise ValueError(
                        f"checkpoint carries a threshold bank for {name!r} "
                        f"at width {width} but this model config does not "
                        f"bank that width (bank_cols={act.cfg.bank_cols}); "
                        "restore with the bank_cols the deployment was "
                        "serving with (--bank-cols)")
        schema1 = " — or a pre-bank schema-1 deployment" \
            if schema < 2 else ""
        for name, act in eng._acts.items():
            saved = {int(w) for w in meta["banks"].get(name, [])}
            extra = sorted(set(act.banks()) - saved)
            if extra:
                raise ValueError(
                    f"model config banks thresholds for {name!r} at widths "
                    f"{extra} but the checkpoint has none there (saved "
                    f"with a different bank_cols"
                    f"{schema1}); "
                    "re-serve a fresh deployment or restore with the "
                    "original bank_cols")
        tree, _, _ = load_checkpoint(root, eng._ckpt_tree(), step=step)
        eng.params = tree["params"]
        eng.state = {"index": int(tree["state"]["index"]),
                     "layers": tree["state"]["layers"]}
        eng.slot_pos = tree["slot_pos"].numpy().astype(np.int32)
        eng.slot_last = tree["slot_last"].numpy().astype(np.int32)
        eng.slot_free = [bool(b) for b in tree["slot_free"].numpy()]
        eng.slot_req = [None if d is None else Request.from_dict(d)
                        for d in meta["requests"]["slots"]]
        eng.queue = [Request.from_dict(d) for d in meta["requests"]["queue"]]
        # the checkpoint was flushed at save, so the host arrays hold
        if eng._detok is not None:
            eng._slot_last_dev = eng._to_dev(eng.slot_last.astype(np.int64))
        for s, req in enumerate(eng.slot_req):
            eng._slot_ntok[s] = 0 if req is None else len(req.generated)
        if meta["device"] is not None:
            eng.device = device_from_dict(meta["device"])
        # re-program the chip exactly as checkpointed
        for name, thr in tree["ramps"].items():
            act = eng._acts[name]
            act.redeploy(act.ramp.with_thresholds(
                thr.numpy().astype(np.float64)))
        for name, banks in tree["ramp_banks"].items():
            act = eng._acts[name]
            for wkey, thr in banks.items():
                width = int(wkey[1:])                   # "w{width}"
                ideal = act.bank_for(width).ideal
                act.redeploy_bank(width, [
                    ideal.with_thresholds(row.astype(np.float64))
                    for row in thr.numpy()])
        return eng
