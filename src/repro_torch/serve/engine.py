"""Batched serving engine: continuous batching over a fixed decode batch.

The JAX package's ``repro/serve/engine.py``, with its semantics copied
exactly:

* a fixed ``(max_batch, max_len)`` decode state allocated once;
* queued requests are admitted into free slots; each prompt minus its
  last token is prefilled into the slot's cache, and the shared ``index``
  becomes the maximum slot position;
* one ``decode_step`` advances every slot a token (greedy argmax over the
  last logits); a request ends at ``max_new_tokens``, its EOS, or the end
  of the cache, and frees its slot at once.

The encoder-decoder (:class:`~repro_torch.nn.encdec.EncDecLM`) is served
on text as the reference's engine serves it: the engine never calls
``start_decode``, so its decode state's cross K/V stay zero.  It deploys
as the other families do, its two stacks (``enc_layers``, ``dec_layers``)
aged, re-programmed and checkpointed as the reference stacks them; it maps
no activation to param leaves, so every weight refresh is chip-wide, as
the reference's.

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
``params`` after ``convert.lm_params_from_jax``; the hybrid's ``groups``
and the encoder-decoder's ``enc_layers`` and ``dec_layers`` stand where
the other families' ``layers`` do, and the hybrid's ``tail`` is a list in
both packages).

The lifecycle (``recal=``, ``drain_before_rejit=``,
``external_maintenance=``): a :class:`~repro_torch.serve.lifecycle.
RecalScheduler` ages the chip every step, re-calibrates ramps whose INL
crossed the policy's threshold, and asks for a chip re-program, which
re-ages the crossbars from the pristine params (kept on the host) into
the engine's own tensors, or refreshes them (the whole chip, or only the
col-tiles behind stalled threshold banks).  The reference bakes the
comparator thresholds into its compiled traces, and a trace serves the
chip it was compiled with: the decode step and each scan-prefill length
the thresholds at their first call since the last re-program, each bucket
those at its compile.  During a drain or maintenance window the
scheduler has already moved the thresholds on the host while those traces
serve the old ones.  The port reads its activations live, so it keeps
each path's programmed state (:meth:`AnalogActivation.deployed`) and
serves it around that path's calls (:meth:`ServingEngine._bound`): its
streams are the reference's through every window.

``obs=``: the :class:`~repro_torch.obs.Obs` bundle (spans, trace events,
counters and latency histograms on the step clock) and the per-chip
:class:`~repro_torch.obs.EnergyMeter`, the reference's names and values.

The deployment (params as served, decode state, slot arrays, served ramps
and banks, requests, the scheduler, the pristine params, the lifecycle
counters and the ``obs`` block) checkpoints with
:meth:`ServingEngine.save` (schema 2) in the reference's layout, stacked
layers (the hybrid's groups, its tail a list; the encoder-decoder's two
stacks, its cross K/V as ``cross_k`` / ``cross_v``) included, and
resumes with :meth:`ServingEngine.restore`, into any prefill or detok
mode: either package restores what the other wrote.

Every decode step and every prefill position runs the model's kernels once
per layer on the ``cuda`` backend.
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
                                         save_checkpoint, stack_layers,
                                         unstack_layers)
from repro_torch.core import crossbar as CB
from repro_torch.core.device import device_from_dict
from repro_torch.obs import ChipEnergyModel, EnergyMeter, Obs
from repro_torch.serve.lifecycle import RecalScheduler, analog_activations


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
    are the reference's (module docstring).

    ``drain_before_rejit``: when a chip re-program comes due mid-wave, stop
    admitting, let the in-flight slots finish on the chip they were served
    (the re-program is deferred), then re-program.  Off (default), the
    re-program lands at once.

    ``external_maintenance``: fleet mode.  A due re-program only raises
    :attr:`maintenance_pending`; the engine keeps serving and admitting on
    the old chip until :meth:`begin_drain` (a
    :class:`~repro_torch.serve.fleet.FleetEngine` planner grants it).

    ``noise_seed`` only seeds the ``noise_key`` leaf a checkpoint carries
    for the reference's reader: no read noise reaches the LM's decode step.
    """

    SCHEMA = 2          # the deployment checkpoint schema written and read

    def __init__(self, model, params, *, max_batch: int, max_len: int,
                 device=None, noise_seed: int = 0, recal=None,
                 drain_before_rejit: bool = False,
                 external_maintenance: bool = False,
                 prefill: str = "scan", prefill_buckets=None,
                 pack_prefill: bool = False, detok_thread: bool = False,
                 obs=None):
        if prefill not in ("scan", "bucketed"):
            raise ValueError(
                f"prefill must be 'scan' or 'bucketed', got {prefill!r}")
        if prefill != "bucketed" and (pack_prefill
                                      or prefill_buckets is not None):
            raise ValueError(
                "pack_prefill / prefill_buckets require prefill='bucketed'")
        self.device = device
        self._acts = analog_activations(model)
        self.scheduler = None
        self.drain_before_rejit = drain_before_rejit
        self.external_maintenance = external_maintenance
        self._rejit_pending = False
        self._maint_pending = False
        # weight-crossbar re-program bookkeeping: the generation salts the
        # tile draws, the prog age anchors the drift clock; a refresh
        # scoped to stalled banks' col-tiles lands in _tile_gens; the
        # shared ordinal keeps every re-program's salt unique
        self._weight_gen = 0
        self._weight_prog_age_s = 0.0
        self._refresh_ord = 0
        self._tile_gens: Dict[str, dict] = {}
        # how the served params were last aged: (the aging device, the
        # generation) and each leaf's col-tile overrides, so a re-program
        # skips the leaves whose aging would not change (None: unknown)
        self._aged_as: Optional[tuple] = None
        self._pristine_params = params
        if recal is not None:
            if device is None:
                raise ValueError("recal policy requires a device model")
            # fab calibration at age 0, then drift to the preset's age
            self.scheduler = RecalScheduler(device, self._acts, recal)
            # what a re-program ages from, kept on the host
            self._pristine_params = _host_copy(params)
        if device is not None and device.has_build_stage:
            params = device.age_params(params,
                                       stacked=_stacked_keys(model))
            self._aged_as = ((device.to_dict(), 0), {})
        elif recal is not None:
            # a re-program writes into the served tensors: not the caller's
            params = _clone(params)
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.dev = model.device
        self.state = model.init_decode_state(max_batch, max_len)
        self._noise_key = np.asarray([0, noise_seed & 0xFFFFFFFF],
                                     np.uint32)
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
        # the chip each path serves (module docstring): bucket -> the
        # state it was "compiled" with; ("decode",) / ("scan", length) ->
        # the state of its first call since the last re-program
        self._prefill_exec: Dict[int, dict] = {}
        self._binds: Dict[tuple, dict] = {}
        self.last_invalidation: Optional[dict] = None
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
        # -- observability: everything is keyed on the step clock (the
        # ordinal of the next step() call), never on wall time, so seeded
        # traces repeat bitwise; checkpointed with the deployment
        self.obs = obs if obs is not None else Obs()
        self._step_ord = 0
        self._submit_ord: Dict[int, int] = {}       # uid -> submit step
        self._submit_wall: Dict[int, float] = {}
        self._slot_last_tok_ord = np.zeros(max_batch, np.int64)
        self._slot_last_tok_wall = np.zeros(max_batch, np.float64)
        o = self.obs
        self._m_tokens = o.counter("serve.tokens_total")
        self._m_submitted = o.counter("serve.requests_submitted")
        self._m_admitted = o.counter("serve.requests_admitted")
        self._m_finished = o.counter("serve.requests_finished")
        self._m_queue_wait = o.histogram("serve.queue_wait_steps")
        self._m_ttft = o.histogram("serve.ttft_steps")
        self._m_itl = o.histogram("serve.itl_steps")
        self._m_ttft_ms = o.histogram("serve.ttft_ms")
        self._m_itl_ms = o.histogram("serve.itl_ms")
        self._m_bucket_hit = o.counter("serve.prefill_bucket_hits")
        self._m_bucket_compile = o.counter("serve.prefill_bucket_compiles")
        self._m_reprograms = o.counter("serve.reprograms")
        self._m_buckets_dropped = o.counter("serve.prefill_buckets_dropped")
        self._m_decode_rebuilds = o.counter("serve.decode_rebuilds")
        # the served params priced under both peripheries (hwcost's model
        # of the analog chip), accumulated per processed token
        self.energy = EnergyMeter(self._energy_price(), o.metrics,
                                  chip=o.chip)
        if self.scheduler is not None:
            self.scheduler.obs = self.obs
        self._refresh_jit()

    def _energy_price(self) -> ChipEnergyModel:
        """The served params priced with the chip's ADC bits, banks and
        Supp. S11 ramp copies."""
        spec = getattr(getattr(self.model, "cfg", None), "analog", None)
        return ChipEnergyModel.price(
            self.params,
            bits=spec.adc_bits if spec is not None else 5,
            bank_cols=spec.bank_cols if spec is not None else 0,
            redundancy=getattr(getattr(self.device, "redundancy", None),
                               "n_copies", 1))

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.dev.type == "cuda":
            return t.pin_memory().to(self.dev, non_blocking=True)
        return t

    # -- the served chip ----------------------------------------------------

    def _snapshot(self) -> dict:
        """The activations' deployed state, by name."""
        return {name: act.deployed() for name, act in self._acts.items()}

    def _serve(self, snap: dict) -> None:
        for name, state in snap.items():
            self._acts[name].serve(state)

    @staticmethod
    def _fp_of(snap: dict) -> tuple:
        """Bytes of every comparator threshold of a state (the ramps and
        the realized banks): the constants a reference trace bakes in."""
        fp = []
        for name in sorted(snap):
            adc, _, banks = snap[name]
            fp.append((name, np.asarray(adc.ramp.thresholds).tobytes(),
                       tuple((w, banks[w][1].tobytes())
                             for w in sorted(banks))))
        return tuple(fp)

    def _threshold_fp(self) -> tuple:
        return self._fp_of(self._snapshot())

    def _bound(self, key: tuple, fn):
        """``fn()`` on the chip that the path ``key`` serves.

        An unbound path serves the activations as they are and is bound to
        that state after its call (banks realized in the call included).
        A bound one has its state swapped in around the call (no copy, no
        upload) and adopts banks realized in the call at their deployed
        state, as the reference's traces serve them."""
        snap = self._prefill_exec[key[1]] if key[0] == "exec" \
            else self._binds.get(key)
        if snap is None:
            out = fn()
            self._binds[key] = self._snapshot()
            return out
        host = self._snapshot()
        self._serve(snap)
        try:
            out = fn()
        finally:
            new = self._snapshot()
            self._serve(host)
        for name, (_, _, banks) in new.items():
            for width, state in banks.items():
                snap[name][2].setdefault(width, state)
        return out

    def _refresh_jit(self):
        """Forget what every path serves (a chip re-program or a restore;
        the reference re-jits) and snapshot the chip the paths now serve:
        during a drain window the scheduler may move the host-side
        thresholds ahead of the served ones, and a checkpoint records the
        served chip."""
        self._prefill_exec.clear()
        self._binds.clear()
        self._served = self._snapshot()

    def _served_bank_state(self) -> dict:
        """Per-act served bank thresholds, banks realized since the last
        re-program at their deployed state."""
        out = {}
        for name, act in self._acts.items():
            snap = self._served[name][2]
            banks = {w: (snap[w][1] if w in snap else bank.thresholds_f64)
                     for w, bank in act.banks().items()}
            if banks:
                out[name] = banks
        return out

    def _served_fp(self) -> tuple:
        banks_all = self._served_bank_state()
        fp = []
        for name in sorted(self._acts):
            banks = banks_all.get(name, {})
            fp.append((name,
                       np.asarray(self._served[name][0].ramp.thresholds)
                       .tobytes(),
                       tuple((w, np.asarray(banks[w]).tobytes())
                             for w in sorted(banks))))
        return tuple(fp)

    def _refresh_jit_selective(self):
        """The reference's bucket-aware re-jit after a chip re-program.

        Buckets whose served thresholds moved are dropped and at once
        bound to the new chip (counted as compiles); the decode and
        scan-prefill paths are rebound only if the served thresholds moved
        (a weight-only re-program keeps them).  What happened lands in
        ``last_invalidation``."""
        new_fp = self._threshold_fp()
        warm = sorted(self._prefill_exec)
        dropped = sorted(b for b, snap in self._prefill_exec.items()
                         if self._fp_of(snap) != new_fp)
        kept = [b for b in warm if b not in dropped]
        decode_rebuilt = self._served_fp() != new_fp
        if decode_rebuilt:
            keep = {b: self._prefill_exec[b] for b in kept}
            self._refresh_jit()
            self._prefill_exec.update(keep)
        else:
            for b in dropped:
                del self._prefill_exec[b]
        for b in dropped:
            self._ensure_prefill_exec(b)
        self.last_invalidation = {
            "kept_buckets": kept, "dropped_buckets": dropped,
            "decode_rebuilt": bool(decode_rebuilt)}
        self._m_reprograms.inc()
        self._m_buckets_dropped.inc(len(dropped))
        if decode_rebuilt:
            self._m_decode_rebuilds.inc()
        self.obs.trace_event("reprogram", kept_buckets=kept,
                             dropped_buckets=dropped,
                             decode_rebuilt=bool(decode_rebuilt))

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

    def _ensure_prefill_exec(self, bucket: int) -> None:
        """Bind a bucket to the chip as it is now, unless it is bound (the
        reference's compile of one executable, and its hit counter)."""
        if bucket in self._prefill_exec:
            self._m_bucket_hit.inc()
            return
        self._m_bucket_compile.inc()
        self._prefill_exec[bucket] = self._snapshot()

    def warmup(self) -> dict:
        """Run every prefill bucket once and one decode step, each on a
        throwaway state: this builds the kernels and cuBLAS's handles
        before traffic arrives and advances no engine state."""
        out = {"prefill_buckets": [], "decode": True}
        P = self._pack_rows
        for b in self.prefill_buckets:
            self._ensure_prefill_exec(b)
            self._bound(("exec", b), lambda b=b: self.model.prefill_cache(
                self.params, self.model.init_decode_state(P, self.max_len),
                torch.zeros((P, b), dtype=torch.int64, device=self.dev),
                np.zeros(P, np.int64)))
            out["prefill_buckets"].append(b)
        self._bound(("decode",), lambda: self._decode_all(
            self.params,
            self.model.init_decode_state(self.max_batch, self.max_len),
            torch.zeros((self.max_batch, 1), dtype=torch.int64,
                        device=self.dev)))
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
        self._submit_ord[req.uid] = self._step_ord
        self._submit_wall[req.uid] = time.perf_counter()
        self._m_submitted.inc()
        self.obs.trace_event("submit", uid=req.uid,
                             prompt_len=int(len(req.prompt)))

    # -- fleet-facing maintenance surface --------------------------------

    @property
    def maintenance_pending(self) -> bool:
        """True while a chip re-program is due or draining toward one."""
        return self._maint_pending or self._rejit_pending

    @property
    def draining(self) -> bool:
        """True once drain started: admission is closed until the
        re-program."""
        return self._rejit_pending

    def begin_drain(self) -> None:
        """Grant the pending maintenance window: stop admitting, let the
        in-flight wave finish on the old chip, then re-program at the
        drain point (top of :meth:`step`).  Hand the queue to siblings
        with :meth:`take_queue` first."""
        self._rejit_pending = True

    def take_queue(self) -> List[Request]:
        """Pop every queued (not yet prefilled) request for a sibling;
        in-flight slots always finish on this chip."""
        out, self.queue = self.queue, []
        return out

    def health(self) -> dict:
        """Load and lifecycle snapshot for routing and planning (no fresh
        probe: the INL is the scheduler's last event's)."""
        sched = self.scheduler
        ev = {}
        if sched is not None and sched.events:
            ev = sched.events[-1]
        return {
            "active": int(sum(not f for f in self.slot_free)),
            "queued": len(self.queue),
            "free_slots": int(sum(self.slot_free)),
            "age_s": 0.0 if sched is None else float(sched.age_s),
            "inl_lsb": float(ev.get("inl_after_lsb",
                                    ev.get("inl_lsb", 0.0))),
            # engine steps since that INL was recorded (-1: never) and
            # the probe cadence, so routers can discount a stale reading
            "inl_age_steps": int(sched.step_count - ev["step"]) if ev
            else -1,
            "check_every": 0 if sched is None
            else int(sched.policy.check_every),
            "maintenance_pending": self.maintenance_pending,
            "draining": self.draining,
            "weight_gen": self._weight_gen,
        }

    def _admit(self):
        """Prefill queued requests into free slots (none while draining
        toward a re-program)."""
        if self._rejit_pending:
            return
        admits = []
        for slot in range(self.max_batch):
            if not self.queue or not self.slot_free[slot]:
                continue
            admits.append((slot, self.queue.pop(0)))
        if not admits:
            return
        # energy: every crossbar macro fires once per cached prompt
        # position (the bucketed path's padding excluded)
        self.energy.add_processed(sum(max(len(r.prompt) - 1, 0)
                                      for _, r in admits))
        with self.obs.span("admit", n=len(admits)):
            if self.prefill_mode == "bucketed":
                self._admit_bucketed(admits)
                return
            for slot, req in admits:
                with self.obs.span("prefill", slot=slot,
                                   length=int(len(req.prompt) - 1)):
                    mini_state = self.model.init_decode_state(
                        1, self.max_len)
                    if len(req.prompt) > 1:
                        tokens = torch.as_tensor(
                            np.asarray(req.prompt, np.int64),
                            device=self.dev)
                        length = len(req.prompt) - 1
                        mini_state = self._bound(
                            ("scan", length),
                            lambda: self._prefill_slot(
                                self.params, mini_state, tokens,
                                length=length))
                        self.prefill_waves += 1
                self._bookkeep_admit(slot, req)
                self._merge_slot(mini_state, slot)

    def _bookkeep_admit(self, slot: int, req: Request):
        wait = self._step_ord - self._submit_ord.get(req.uid,
                                                     self._step_ord)
        self._m_queue_wait.record(wait)
        self._m_admitted.inc()
        self.obs.trace_event("admit", uid=req.uid, slot=slot,
                             queue_wait_steps=int(wait))
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
                called = []
                with self.obs.span("prefill", rows=len(group),
                                   max_len=int(l_max)) as sp:
                    while pos < l_max:
                        bucket = self._bucket_for(l_max - pos)
                        self._ensure_prefill_exec(bucket)
                        called.append(bucket)
                        chunk = np.zeros((P, bucket), np.int64)
                        width = min(bucket, l_max - pos)
                        chunk[:, :width] = toks[:, pos:pos + width]
                        # the state's shared index carries the global
                        # position between chunks
                        state = self._bound(
                            ("exec", bucket),
                            lambda: self.model.prefill_cache(
                                self.params, state, self._to_dev(chunk),
                                vlen))
                        self.prefill_steps += bucket
                        pos += bucket
                    sp.set(buckets=called)
                self.buckets_called += called
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
        for big, small in self._batched_leaves(mini):
            big[slots] = small[rows]

    def _batched_leaves(self, other):
        """``(engine leaf, other leaf)`` for every batched tensor of the
        decode state, whatever the family's layout (the model's
        :meth:`~repro_torch.nn.transformer.LM.blocks`): KV caches,
        recurrent states and conv histories, each with its batch on axis
        0."""
        for (_, big), (_, small) in zip(self.model.blocks(self.state),
                                        self.model.blocks(other)):
            for name, t in big.items():
                yield t, small[name]

    def _merge_slot(self, mini_state, slot: int):
        """Copy the single-request cache into batch slot ``slot``, every
        tensor of it (K and V, and for an int8 cache their scales); the
        shared index becomes the maximum slot position (the reference's
        documented simplification of per-slot indices)."""
        for big, small in self._batched_leaves(mini_state):
            big[slot:slot + 1].copy_(small)
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
        self.obs.set_step(self._step_ord)
        if self._rejit_pending and all(self.slot_free):
            # the wave drained: apply the deferred chip re-program, then
            # admit again on the new chip
            self._rejit_pending = False
            self._on_chip_reprogram()
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
            self._step_ord += 1
            return self._detok.pop_one() if self._detok is not None else {}
        t0 = time.perf_counter()
        with self.obs.span("decode", active=len(active)):
            out = self._step_detok(active) if self._detok is not None \
                else self._step_sync(active)
        self.decode_seconds += time.perf_counter() - t0
        self.energy.add_processed(len(active))
        if self.scheduler is not None and self.scheduler.tick():
            self._handle_reprogram_due(active)
        self._step_ord += 1
        return out

    def _step_sync(self, active) -> Dict[int, int]:
        """The synchronous decode step: dispatch, block on the host
        transfer, do the per-request bookkeeping inline."""
        tokens = torch.as_tensor(self.slot_last[:, None].astype(np.int64),
                                 device=self.dev)
        next_tok, self.state = self._bound(
            ("decode",), lambda: self._decode_all(self.params, self.state,
                                                  tokens))
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
            self._note_token(s, req.uid)
            done = (len(req.generated) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.slot_pos[s] >= self.max_len - 1)
            if done:
                self._note_finish(s, req.uid)
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
        next_tok, self.state = self._bound(
            ("decode",), lambda: self._decode_all(
                self.params, self.state, self._slot_last_dev[:, None]))
        self.decode_steps += 1
        mask = np.zeros(self.max_batch, bool)
        mask[active] = True
        self._slot_last_dev = torch.where(self._to_dev(mask), next_tok,
                                          self._slot_last_dev)
        self._detok.put(next_tok, [(s, self.slot_req[s]) for s in active])
        for s in active:
            uid = self.slot_req[s].uid
            self.slot_pos[s] += 1
            self._note_token(s, uid)
            if (self._slot_ntok[s] >= self.slot_req[s].max_new_tokens
                    or self.slot_pos[s] >= self.max_len - 1):
                # the worker still holds the request; its stream finishes
                # landing asynchronously
                self._note_finish(s, uid)
                self.slot_free[s] = True
                self.slot_req[s] = None
        return self._detok.pop_one()

    def _note_token(self, s: int, uid: int) -> None:
        """Per-token obs bookkeeping at dispatch time, the same on the
        sync and detok paths (the ``_slot_ntok`` 0 -> 1 step marks the
        first token, whoever owns ``generated``)."""
        now = time.perf_counter()
        if self._slot_ntok[s] == 0:
            ttft = self._step_ord - self._submit_ord.pop(uid,
                                                         self._step_ord)
            self._m_ttft.record(ttft)
            sub_wall = self._submit_wall.pop(uid, None)
            if sub_wall is not None:
                self._m_ttft_ms.record((now - sub_wall) * 1e3)
            self.obs.trace_event("first_token", uid=uid,
                                 ttft_steps=int(ttft))
        else:
            self._m_itl.record(self._step_ord
                               - self._slot_last_tok_ord[s])
            self._m_itl_ms.record(
                (now - self._slot_last_tok_wall[s]) * 1e3)
        self._slot_ntok[s] += 1
        self._slot_last_tok_ord[s] = self._step_ord
        self._slot_last_tok_wall[s] = now
        self._m_tokens.inc()
        self.energy.add_generated(1)

    def _note_finish(self, s: int, uid: int) -> None:
        self._m_finished.inc()
        self.obs.trace_event("finish", uid=uid,
                             n_tokens=int(self._slot_ntok[s]))

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

    # -- the lifecycle ------------------------------------------------------

    def shelf_tick(self, age_per_step_s: float) -> None:
        """Age a chip that served no traffic this step (fleet shelf
        aging): drift accrues and the probe cadence keeps running, so an
        unrouted canary can still warn.  :meth:`step`'s tick and
        re-program, at ``age_per_step_s``."""
        if self.scheduler is None:
            return
        if self.scheduler.tick(age_per_step_s=age_per_step_s):
            self._handle_reprogram_due([])

    def _handle_reprogram_due(self, active):
        """A scheduler tick moved the thresholds: re-program now, or defer
        it per the maintenance policy."""
        if self.external_maintenance:
            # fleet mode: keep serving (and admitting) the old chip until
            # the planner calls begin_drain()
            self._maint_pending = True
        elif self.drain_before_rejit \
                and not all(self.slot_free[s] for s in active):
            # drain the in-flight wave first, on the chip it was served
            self._rejit_pending = True
        else:
            # also settles an earlier deferral: one re-program covers
            # every threshold move up to the scheduler's current age
            self._rejit_pending = False
            self._on_chip_reprogram()

    def _on_chip_reprogram(self):
        """Re-program the chip at the scheduler's current age.

        The weight crossbars drift on the same clock: they are re-aged
        from the pristine params into the served tensors (the per-tile
        draws are keyed, so one age is one chip), then every path serves
        the new thresholds.  A pending weight refresh re-programs the
        crossbars instead: the whole chip (a new generation salt, the
        drift clock restarted), or, when every stalled ramp is a bank of
        an activation that maps to param leaves
        (``model.act_param_leaves``), only the col-tiles feeding those
        banks.
        """
        sched = self.scheduler
        if sched is None:
            # a forced drain of a chip without a scheduler: nothing ages
            self._maint_pending = False
            self._refresh_jit_selective()
            return
        # after a restored drain window the activations hold the served
        # (old) thresholds: deploy the scheduler's current-age state first
        sched.redeploy()
        if self.device is not None:
            stalled = list(sched.weight_refresh_ramps)
            if sched.consume_weight_refresh():
                self._refresh_ord += 1
                scope = self._per_tile_refresh_scope(stalled)
                if scope is not None:
                    for key in scope:
                        self._tile_gens[key] = {"gen": self._refresh_ord,
                                                "age_s": sched.age_s}
                else:
                    # a full-chip rewrite supersedes any partial one
                    self._weight_gen = self._refresh_ord
                    self._weight_prog_age_s = sched.age_s
                    self._tile_gens.clear()
        if self.device is not None \
                and (sched.policy.age_per_step_s > 0 or self._weight_gen
                     or self._tile_gens):
            t_eff = max(sched.age_s - self._weight_prog_age_s, 0.0)
            aged_dev = self.device.with_drift(t_eff)
            if aged_dev.has_build_stage:
                self._reage(aged_dev)
        self._maint_pending = False
        self._refresh_jit_selective()

    def _reage(self, aged_dev) -> None:
        """Age the pristine params on ``aged_dev`` into the served tensors.
        Where the device and the generation are those of the last aging,
        a leaf whose col-tile overrides are unchanged holds this aging
        already and is left as it is: a refresh of some col-tiles rewrites
        only the leaves under them."""
        base = self._tile_overrides_fn()
        covs: Dict[str, Optional[dict]] = {}

        def overrides(path, shape):
            covs[path] = None if base is None else base(path, shape)
            return covs[path]

        key = (aged_dev.to_dict(), self._weight_gen)
        last = self._aged_as if self._aged_as is not None \
            and self._aged_as[0] == key else None
        aged_dev.age_params(
            self._pristine_params, stacked=_stacked_keys(self.model),
            generation=self._weight_gen, leaf_overrides=overrides,
            out=self.params,
            keep=None if last is None
            else (lambda path, cov: last[1].get(path) == cov))
        self._aged_as = (key, covs)

    def _per_tile_refresh_scope(self, stalled):
        """The bank keys a col-tile-scoped rewrite covers, or None: every
        stalled ramp must be a bank key of an activation the model maps to
        param leaves; anything else re-programs the whole chip."""
        if not stalled:
            return None
        leaf_map = getattr(self.model, "act_param_leaves", None)
        if leaf_map is None:
            return None
        mapped = leaf_map()
        for key in stalled:
            if "@" not in key or key.split("@", 1)[0] not in mapped:
                return None
        return stalled

    def _tile_overrides_fn(self):
        """``_tile_gens`` as an ``age_params`` ``leaf_overrides``: for
        each leaf feeding a refreshed bank, the col-tiles meeting that
        bank's output columns carry the bank's own (generation, drift
        age)."""
        if not self._tile_gens:
            return None
        mapped = self.model.act_param_leaves()
        # act -> [(width, col_lo, col_hi, gen, prog_age)] in sorted key
        # order, so overlapping spans resolve deterministically
        spans: Dict[str, list] = {}
        for key, rec in sorted(self._tile_gens.items()):
            name, rest = key.split("@", 1)
            width_s, j_s = rest.split(":")
            width, j = int(width_s), int(j_s)
            bc = self._acts[name].cfg.bank_cols
            spans.setdefault(name, []).append(
                (width, j * bc, min((j + 1) * bc, width),
                 int(rec["gen"]), float(rec["age_s"])))
        sched_age = self.scheduler.age_s

        def overrides(path, shape):
            cov = {}
            for name, spanlist in spans.items():
                if not any(p in path for p in mapped.get(name, ())):
                    continue
                plan = CB.plan_tiles(shape[-2], shape[-1])
                for width, lo, hi, gen, prog_age in spanlist:
                    if shape[-1] != width:
                        continue
                    t_eff = max(sched_age - prog_age, 0.0)
                    for (ti, tj), _, cs in plan.blocks():
                        if ti == 0 and cs.start < hi and cs.stop > lo:
                            cov[tj] = (gen, t_eff)
            return cov or None

        return overrides

    def run_to_completion(self, max_iters: int = 10_000) -> int:
        """Drain the queue; returns the number of tokens generated."""
        n = 0
        for _ in range(max_iters):
            if not self.queue and all(self.slot_free):
                break
            n += len(self.step())
        # the last steps are still landing on the detokenize thread
        n += sum(len(batch) for batch in self.detok_flush())
        if self._rejit_pending and all(self.slot_free):
            # settle a deferred re-program once the last wave drained
            self._rejit_pending = False
            self._on_chip_reprogram()
        return n

    def run_offline(self, requests=None, max_iters: int = 100_000) -> dict:
        """Submit the whole burst up front and drain it.  Host-clock rates
        (a prefill wave ends on a device synchronize; so does a
        synchronous decode step, while with the detokenize thread a decode
        step's time is its dispatch): tokens/s over the run, ms per decode
        step, per prefill position and per prefill wave; the TTFT and
        inter-token latency distributions in steps and host ms; and the
        energy report (hwcost's model of the analog chip)."""
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
                "prefill_wave_ms": 1e3 * psec / waves if waves else 0.0,
                "ttft_steps": self._m_ttft.summary(),
                "itl_steps": self._m_itl.summary(),
                "ttft_ms": self._m_ttft_ms.summary(),
                "itl_ms": self._m_itl_ms.summary(),
                "energy": self.energy.report()}

    # -- checkpoint / restore ---------------------------------------------

    def _ckpt_tree(self, include_pristine: bool, pristine=None):
        """The array state of the deployment in the reference's layout
        (:func:`_stack_params`, :func:`_stack_state`: one leaf at a time
        on the host).  ``pristine`` (the pre-aging params) is stored only
        with a scheduler, as the reference stores it; a restore template
        passes its own host stand-ins."""
        model = self.model
        tree = {
            "params": _stack_params(model, self.params),  # aged, as served
            "state": _stack_state(model, dict(self.state, index=torch.tensor(
                self.state["index"], dtype=torch.int32))),
            "noise_key": self._noise_key,
            "slot_pos": np.asarray(self.slot_pos),
            "slot_last": np.asarray(self.slot_last),
            "slot_free": np.asarray(self.slot_free, np.bool_),
            # the SERVED comparator thresholds (float64): a restore is
            # the running chip even inside a drain window
            "ramps": {name: np.asarray(snap[0].ramp.thresholds)
                      for name, snap in self._served.items()},
            # the banked (n_col_tiles, P) layout per realized width
            "ramp_banks": {
                name: {f"w{width}": np.asarray(thr)
                       for width, thr in sorted(banks.items())}
                for name, banks in self._served_bank_state().items()},
        }
        if include_pristine:
            src = self._pristine_params if pristine is None else pristine
            tree["pristine"] = _stack_params(model, src)
        return tree

    def save(self, root: str, step: int) -> str:
        """Atomic full-deployment checkpoint; returns the directory.  The
        tree and the metadata (schema 2, with the scheduler, the lifecycle
        counters and the ``obs`` block) are the reference's."""
        # land the detokenize backlog first: `generated` and the host
        # last-token mirror must be caught up before they are written
        self.detok_flush()
        meta = {
            "schema": self.SCHEMA,
            "engine": {"max_batch": self.max_batch, "max_len": self.max_len},
            "device": None if self.device is None else self.device.to_dict(),
            "scheduler": None if self.scheduler is None
            else self.scheduler.to_dict(),
            "banks": {name: sorted(act.banks())
                      for name, act in self._acts.items() if act.banks()},
            "lifecycle": {"weight_gen": self._weight_gen,
                          "weight_prog_age_s": self._weight_prog_age_s,
                          "rejit_pending": self._rejit_pending,
                          "maint_pending": self._maint_pending,
                          "refresh_ord": self._refresh_ord,
                          "tile_gens": {k: dict(v) for k, v
                                        in self._tile_gens.items()}},
            "requests": {
                "slots": [None if r is None else r.to_dict()
                          for r in self.slot_req],
                "queue": [r.to_dict() for r in self.queue],
            },
            # metrics, the tracer's clock and the per-request step
            # bookkeeping: a restored deployment's counters, histograms
            # and trace continue where the saved run stopped
            "obs": {
                **self.obs.snapshot(),
                "step_ord": int(self._step_ord),
                "submit_ord": {str(k): int(v)
                               for k, v in self._submit_ord.items()},
                "slot_last_tok_ord": [int(x)
                                      for x in self._slot_last_tok_ord],
            },
        }
        paths = self._paths_meta()
        if paths is not None:
            meta["paths"] = paths
        return save_checkpoint(
            root, step,
            self._ckpt_tree(include_pristine=self.scheduler is not None),
            metadata=meta)

    def _paths_meta(self) -> Optional[dict]:
        """The chip of every path and of the host, for the port's restore
        to resume exactly where a path holds another chip than the served
        snapshot (inside a window) or a bucket is bound (the reference
        recompiles its buckets after a restore; the port counts them as
        still compiled, as the uninterrupted run does).  The reference's
        reader ignores it and serves the snapshot everywhere
        (``ROADMAP.md`` queue C).  None when there is nothing to keep."""
        host = self._snapshot()
        served_fp = self._served_fp()
        keyed = [("host", host)] + \
            [("exec", b, snap) for b, snap in self._prefill_exec.items()] + \
            [(*key, snap) for key, snap in self._binds.items()]
        if not self._prefill_exec and all(
                self._fp_of(item[-1]) == served_fp for item in keyed):
            return None
        states, index = [], {}

        def ref(snap):
            fp = self._fp_of(snap)
            if fp not in index:
                index[fp] = len(states)
                states.append({
                    name: {"ramp": np.asarray(adc.ramp.thresholds).tolist(),
                           "banks": {str(w): b[1].tolist()
                                     for w, b in sorted(banks.items())}}
                    for name, (adc, _, banks) in snap.items()})
            return index[fp]

        out = {"host": ref(host), "decode": None, "scan": {}, "exec": {}}
        for item in keyed[1:]:
            kind, snap = item[0], item[-1]
            if kind == "decode":
                out["decode"] = ref(snap)
            else:
                out[kind][str(item[1])] = ref(snap)
        out["states"] = states
        return out

    def _restore_paths(self, paths: dict) -> None:
        """Put back each path's chip and the host's (:meth:`_paths_meta`)."""
        snaps = []
        for state in paths["states"]:
            for name, rec in state.items():
                act = self._acts[name]
                act.redeploy(act.ramp.with_thresholds(
                    np.asarray(rec["ramp"], np.float64)))
                for w, rows in rec["banks"].items():
                    ideal = act.bank_for(int(w)).ideal
                    act.redeploy_bank(int(w), [
                        ideal.with_thresholds(np.asarray(r, np.float64))
                        for r in rows])
            snaps.append(self._snapshot())
        if paths["decode"] is not None:
            self._binds[("decode",)] = snaps[paths["decode"]]
        for length, i in paths["scan"].items():
            self._binds[("scan", int(length))] = snaps[i]
        for bucket, i in paths["exec"].items():
            self._prefill_exec[int(bucket)] = snaps[i]
        self._serve(snaps[paths["host"]])

    @classmethod
    def restore(cls, model, root: str, *, step: Optional[int] = None,
                params_like=None, drain_before_rejit: bool = False,
                external_maintenance: bool = False, prefill: str = "scan",
                prefill_buckets=None, pack_prefill: bool = False,
                detok_thread: bool = False, obs=None) -> "ServingEngine":
        """Resume a checkpointed deployment (the port's or the
        reference's): same chip, same next token, in any prefill or detok
        mode (the modes share one state layout).

        ``params_like``: a tree of the model's params structure, whose
        tensors the checkpoint's params overwrite in place (default
        ``model.init`` from seed 0), so the card never holds two copies
        of the weights.  Params, decode caches, slot arrays, requests,
        the queue, the served ramps and banks, the scheduler, the
        lifecycle counters and the ``obs`` block all come from the
        checkpoint; the pristine params (with a scheduler) land on the
        host."""
        step, meta = read_metadata(root, step=step)
        if "engine" not in meta:
            hint = ("this is a fleet manifest — restore via "
                    "repro_torch.serve.fleet.FleetEngine.restore"
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
        if params_like is None:
            gen = torch.Generator(device=model.device)
            gen.manual_seed(0)
            params_like = model.init(gen)
        eng = cls(model, params_like,
                  max_batch=meta["engine"]["max_batch"],
                  max_len=meta["engine"]["max_len"],
                  drain_before_rejit=drain_before_rejit,
                  external_maintenance=external_maintenance,
                  prefill=prefill, prefill_buckets=prefill_buckets,
                  pack_prefill=pack_prefill, detok_thread=detok_thread,
                  obs=obs)
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
        has_sched = meta.get("scheduler") is not None
        # the pristine params come back as new host tensors
        host = _map(eng.params, lambda t: 0) if has_sched else None
        tree, _, _ = load_checkpoint(
            root, eng._ckpt_tree(include_pristine=has_sched, pristine=host),
            step=step)
        # matching leaves were written into the engine's own tensors
        eng.params = _unstack_params(model, tree["params"])
        eng.state = dict(_unstack_state(model, tree["state"]),
                         index=int(tree["state"]["index"]))
        if has_sched:
            eng._pristine_params = _unstack_params(model, tree["pristine"])
        else:
            # nothing re-ages without a scheduler
            eng._pristine_params = eng.params
        eng._noise_key = np.asarray(tree["noise_key"], np.uint32)
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
            # priced with the chip's ramp copies, as the saved run was
            # (the reference's restore keeps one: ROADMAP.md queue C)
            eng.energy.model = eng._energy_price()
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
        lc = meta["lifecycle"]
        eng._weight_gen = int(lc.get("weight_gen", 0))
        eng._weight_prog_age_s = float(lc.get("weight_prog_age_s", 0.0))
        eng._rejit_pending = bool(lc.get("rejit_pending", False))
        eng._maint_pending = bool(lc.get("maint_pending", False))
        eng._refresh_ord = int(lc.get("refresh_ord", lc.get("weight_gen",
                                                            0)))
        eng._tile_gens = {k: {"gen": int(v["gen"]),
                              "age_s": float(v["age_s"])}
                          for k, v in lc.get("tile_gens", {}).items()}
        if has_sched:
            eng.scheduler = RecalScheduler.from_dict(
                meta["scheduler"], eng._acts)
            eng.scheduler.obs = eng.obs
        # counters, histograms and the trace clock continue (a fresh
        # clock for a checkpoint without the block)
        obs_meta = meta.get("obs")
        if obs_meta:
            eng.obs.restore(obs_meta)
            eng._step_ord = int(obs_meta.get("step_ord", 0))
            eng._submit_ord = {int(k): int(v) for k, v
                               in obs_meta.get("submit_ord", {}).items()}
            slto = obs_meta.get("slot_last_tok_ord")
            if slto is not None and len(slto) == eng.max_batch:
                eng._slot_last_tok_ord = np.asarray(slto, np.int64)
        # wall anchors are process-local: restart them at restore time
        eng._slot_last_tok_wall[:] = time.perf_counter()
        eng._refresh_jit()
        if meta.get("paths"):
            eng._restore_paths(meta["paths"])
        return eng


def _family(model) -> str:
    return getattr(getattr(model, "cfg", None), "family", "")


def _stacked_keys(model) -> Tuple[str, ...]:
    """The params keys whose per-layer lists the reference stacks on a
    leading axis: the encoder-decoder's ``enc_layers`` and ``dec_layers``,
    the hybrid's ``groups`` (its ``tail`` is a list there too), else
    ``layers``."""
    family = _family(model)
    if family == "encdec":
        return ("enc_layers", "dec_layers")
    return ("groups",) if family == "hybrid" else ("layers",)


def _stack_params(model, tree) -> dict:
    """A params tree in the reference's layout: each list of
    :func:`_stacked_keys` as :func:`stack_layers` leaves."""
    return dict(tree, **{k: stack_layers(tree[k])
                         for k in _stacked_keys(model)})


def _unstack_params(model, tree) -> dict:
    """The inverse of :func:`_stack_params`."""
    return dict(tree, **{k: unstack_layers(tree[k])
                         for k in _stacked_keys(model)})


def _stack_state(model, state) -> dict:
    """A decode state in the reference's layout: stacked under the params'
    key (``layers``, the hybrid's ``groups``), or for the encoder-decoder
    its ``self`` caches stacked and its ``cross`` list of ``{"k", "v"}``
    as ``cross_k`` and ``cross_v``, each (n_dec, B, enc_len, Hkv, D)."""
    if _family(model) != "encdec":
        return _stack_params(model, state)
    tree = {k: v for k, v in state.items() if k != "cross"}
    tree["self"] = stack_layers(state["self"])
    for name in "kv":
        tree[f"cross_{name}"] = stack_layers([c[name]
                                              for c in state["cross"]])
    return tree


def _unstack_state(model, tree) -> dict:
    """The inverse of :func:`_stack_state`."""
    if _family(model) != "encdec":
        return _unstack_params(model, tree)
    state = {k: v for k, v in tree.items()
             if k not in ("cross_k", "cross_v")}
    state["self"] = unstack_layers(tree["self"])
    state["cross"] = [{"k": k, "v": v} for k, v in zip(
        unstack_layers(tree["cross_k"]), unstack_layers(tree["cross_v"]))]
    return state


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _host_copy(params):
    """A params tree on the host (the pristine weights a re-program ages
    from, never written): host tensors are shared, card ones copied."""
    return _map(params, lambda t: t.detach().cpu())


def _clone(params):
    return _map(params, lambda t: t.detach().clone())
