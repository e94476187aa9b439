"""Decoder-only LM: the dense and MoE families' decode path.

The serving slice of the JAX package's ``repro/nn/transformer.py``:
``init``, ``embed``, ``logits``, ``layer_kinds``, ``init_decode_state``
(bf16/f32 or int8 KV cache), the ``attn`` and ``moe_attn`` blocks'
``_decode_block`` and ``decode_step``.  Where the reference scans over
stacked layer params, the port keeps one param dict and one cache dict per
layer and loops over them.  One NL-ADC activation (the hidden ``silu``
ramp, thresholds on the model's device) is shared by every layer, and one
sigmoid NL-ADC by every MoE router.

Only ``family`` ``"dense"`` and ``"moe"`` in ``exact`` analog mode are
ported: the other families and the ``infer``/``train`` modes raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them,
and the full-sequence ``forward``/``loss`` wait for the forward/training
slice.  The model lives on the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as MOE
from repro_torch.nn.mlp import make_activation, mlp_apply, mlp_init, \
    mlp_type_for

FAMILIES = ("dense", "moe")


def _model_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; a CUDA device without a GPU
    raises rather than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    return device


class LM:
    """A decoder-only language model for one dense or MoE
    :class:`ModelConfig`, its activation ramps on ``device`` (default
    ``cuda``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet; "
                f"ROADMAP.md queue A item 5 (LM families) brings it")
        if cfg.analog.enabled and cfg.analog.mode != "exact":
            raise NotImplementedError(
                f"analog mode {cfg.analog.mode!r} on the LM is not ported "
                f"yet; ROADMAP.md queue A item 3 (the LM's infer and train "
                f"modes) brings it")
        if cfg.family == "moe" and cfg.moe_impl != "gspmd":
            raise NotImplementedError(
                f"moe_impl={cfg.moe_impl!r} (expert parallelism) is not "
                f"ported yet; ROADMAP.md queue A item 6 (distribution) "
                f"brings it")
        self.cfg = cfg
        self.device = _model_device(device)
        self.compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32
        self.mlp_kind = mlp_type_for(cfg)
        self.act = make_activation(cfg, self.device)     # hidden NL-ADC
        # the MoE router's NL-ADC, one chip's ramp shared by every layer
        self.sigmoid_act = AnalogActivation(
            "sigmoid", AnalogConfig.from_spec(cfg.analog), self.device)
        # realize the d_ff-wide threshold bank (the MLP gate's output)
        # once, here, rather than inside the first step
        self.act.bank_for(cfg.d_ff)

    # -- init -----------------------------------------------------------

    def layer_kinds(self):
        kind = "moe_attn" if self.cfg.family == "moe" else "attn"
        return (kind,) * self.cfg.n_layers

    def _block_init(self, generator: torch.Generator, kind: str):
        cfg = self.cfg
        d = cfg.d_model
        blk = {
            "norm1": L.rmsnorm_init(d, generator.device),
            "attn": A.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, qkv_bias=cfg.qkv_bias),
            "norm2": L.rmsnorm_init(d, generator.device),
        }
        if kind == "moe_attn":
            blk["moe"] = MOE.moe_init(generator, d, cfg.d_ff, cfg.n_experts,
                                      cfg.n_shared_experts, self.mlp_kind)
        else:
            blk["mlp"] = mlp_init(generator, d, cfg.d_ff, self.mlp_kind)
        return blk

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded float32 params on the generator's device: ``embed``,
        ``final_norm``, ``lm_head`` (untied only) and ``layers``, a list of
        per-layer dicts."""
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": L.embedding_init(generator, cfg.padded_vocab,
                                      cfg.d_model),
            "final_norm": L.rmsnorm_init(cfg.d_model, generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                             cfg.padded_vocab)
        params["layers"] = [self._block_init(generator, kind)
                            for kind in self.layer_kinds()]
        return params

    # -- embedding and readout --------------------------------------------

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return L.embedding_apply(params["embed"], tokens,
                                 compute_dtype=self.compute_dtype)

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            return L.embedding_attend(params["embed"], x)
        return L.dense_apply(params["lm_head"], x,
                             compute_dtype=self.compute_dtype).float()

    # -- decode path -------------------------------------------------------

    def init_decode_state(self, batch: int, max_len: int) -> Dict:
        """``index`` (the shared position, a Python int) and one cache per
        layer on the model's device: int8 codes with bfloat16 scales when
        ``kv_cache_dtype == "int8"``, else the compute dtype."""
        cfg = self.cfg
        layers: List[Dict] = [
            A.init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                         dtype=self.compute_dtype,
                         quantized=cfg.kv_cache_dtype == "int8",
                         device=self.device)
            for _ in range(cfg.n_layers)]
        return {"index": 0, "layers": layers}

    def _decode_block(self, p, cache_l, x, kind: str, index: int):
        cfg = self.cfg
        h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        y, new = A.decode_self_attention(
            p["attn"], h, cache_l, index, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, analog_backend=cfg.analog.backend)
        x = x + y
        h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        if kind == "moe_attn":
            return x + MOE.moe_apply(
                p["moe"], h, top_k=cfg.top_k,
                capacity_factor=max(cfg.capacity_factor, 2.0),
                act=self.act, router_score=cfg.router_score,
                router_act=self.sigmoid_act), new
        return x + mlp_apply(p["mlp"], h, self.mlp_kind, self.act), new

    def decode_step(self, params, state: Dict, tokens: torch.Tensor):
        """One decode step.  tokens: (B, 1) -> (logits (B, 1, V), new
        state).  The caches are updated in place (see
        :func:`repro_torch.nn.attention.decode_self_attention`)."""
        index = state["index"]
        x = self.embed(params, tokens)
        layers = []
        for p, cache_l, kind in zip(params["layers"], state["layers"],
                                    self.layer_kinds()):
            x, new = self._decode_block(p, cache_l, x, kind, index)
            layers.append(new)
        return self.logits(params, x), {"index": index + 1,
                                        "layers": layers}
