"""Model factory: one entry point for the ported LM architectures
(:class:`~repro_torch.nn.transformer.LM`, and
:class:`~repro_torch.nn.encdec.EncDecLM` for the encoder-decoder family).

Also home of the family-agnostic cache-writing prefill
(:func:`prefill_cache`), the JAX package's ``repro/nn/model.py``: a masked
run of ``decode_step`` that fills the decode caches of a batch of prompts
of different lengths, one fixed-width chunk at a time: the building block
of the serving engine's bucketed, packed and chunked prefill.
:class:`~repro_torch.nn.transformer.LM` and
:class:`~repro_torch.nn.encdec.EncDecLM` delegate to it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def build(cfg: ModelConfig, device=None, mesh=None):
    """Return the model object for a config, its ramps on ``device``:
    ``cuda`` unless the caller asks for another (``device="cpu"``); without
    a GPU the default raises.  ``mesh``: the ``DeviceMesh`` a MoE with
    ``moe_impl="ep_shardmap"`` runs its experts over (:class:`LM`)."""
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import EncDecLM

        return EncDecLM(cfg, device)
    if cfg.family == "lstm":
        raise ValueError(
            "LSTM workloads use repro_torch.nn.lstm directly (see "
            "repro_torch.launch.lstm_eval)")
    from repro_torch.nn.transformer import LM

    return LM(cfg, device, mesh=mesh)


# ---------------------------------------------------------------------------
# Cache-writing chunked prefill over the decode seam
# ---------------------------------------------------------------------------


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def decode_state_batch_axes(model):
    """Per-leaf batch axis of ``model.init_decode_state``'s tree.

    Found structurally, as the reference does: build the state for two
    batch sizes (9 cache slots, a few KB) and see which dimension moved.
    Leaves without a batch dimension (the shared ``index``) map to -1.
    Every state leaf of the port's models has its batch on axis 0, the
    layout :func:`prefill_cache` and the engine's slot copies use; what
    follows differs by block: a KV cache's slots, an SSD state's heads, a
    conv history's last inputs, an RG-LRU state's width, the
    encoder-decoder's cross K/V frames.
    """
    s1 = model.init_decode_state(1, 9)
    s2 = model.init_decode_state(2, 9)

    def one(a, b):
        sa, sb = tuple(getattr(a, "shape", ())), tuple(getattr(b, "shape", ()))
        diffs = [i for i, (x, y) in enumerate(zip(sa, sb)) if x != y]
        if not diffs:
            return -1
        if len(diffs) > 1:
            raise ValueError(
                f"decode-state leaf {sa} -> {sb} changes more than one "
                "dimension with batch size; cannot infer the batch axis")
        return diffs[0]

    return _map2(one, s1, s2)


def prefill_cache(model, params, state, tokens, valid_len):
    """Advance ``state`` over a fixed-width token chunk, batched per row.

    ``tokens``: ``(P, B)`` token ids on the model's device, ``B`` prompt
    positions for ``P`` rows, zero-padded past each row's length.
    ``valid_len``: ``(P,)`` each row's TOTAL prefill length (global, so
    chunked calls keep passing the same value).  Each of the ``B`` steps
    is one ``decode_step`` over all ``P`` rows; a row commits a step only
    while ``state["index"] + t < valid_len[row]``, and the shared
    ``index`` always advances.  The committed leaves are what a
    row-at-a-time run of ``decode_step`` writes, since it IS the decode
    path; chunking falls out of the shared ``index`` (call again with the
    next ``B`` columns).

    The reference computes a masked row's step and discards it, keeping
    the row's old value (``where(take, fresh, old)``).  ``decode_step``
    writes a KV cache in place, at the one slot
    :meth:`~repro_torch.nn.transformer.LM.written_slot` names (``index``
    clamped to the last slot, or ``index % slots`` in a rolling cache), so
    the port copies the masked rows' slot before the step and writes it
    back after: later steps read up to the shared ``index``.  A recurrent
    block's state (``ssm``, ``conv``, ``h``) is replaced whole by the
    step, so its masked rows are selected back from the old tensors.  A
    block of the model's ``read_only_kinds`` (the encoder-decoder's cross
    K/V) is only read by the step and is left as it is.  A step in which
    every row commits copies and selects nothing.

    The reference also takes a noise key, folded per global position.
    Nothing in the LM's decode step reads one (infer mode reads the ramps
    programmed at build time), so the port takes none.
    """
    valid = np.asarray(valid_len.cpu() if isinstance(valid_len, torch.Tensor)
                       else valid_len).astype(np.int64)
    i0 = int(state["index"])
    read_only = getattr(model, "read_only_kinds", ())
    for t in range(tokens.shape[1]):
        pos = i0 + t
        masked = np.flatnonzero(pos >= valid)
        if not masked.size:
            _, state = model.decode_step(params, state, tokens[:, t:t + 1])
            continue
        rows = torch.as_tensor(masked, device=tokens.device)
        old = model.blocks(state)
        held = [(leaf, slot, leaf[rows, slot].clone())
                for kind, cache in old for leaf in cache.values()
                for slot in [model.written_slot(kind, pos, leaf.shape[1])]
                if slot is not None]
        _, state = model.decode_step(params, state, tokens[:, t:t + 1])
        for leaf, slot, kept in held:
            leaf[rows, slot] = kept
        take = torch.as_tensor(pos < valid, device=tokens.device)
        for (kind, before), (_, after) in zip(old, model.blocks(state)):
            if kind not in read_only \
                    and model.written_slot(kind, pos, 1) is None:  # replaced
                for name, fresh in after.items():
                    keep = take.view((-1,) + (1,) * (fresh.dim() - 1))
                    after[name] = torch.where(keep, fresh, before[name])
    return state
