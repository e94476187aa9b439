"""Decoder-only LM: the dense and MoE families.

The JAX package's ``repro/nn/transformer.py`` for its ``attn`` and
``moe_attn`` blocks: ``init``, ``embed``, ``logits``, ``layer_kinds``,
the full-sequence ``forward`` / ``loss`` / ``prefill``, and the decode
path (``init_decode_state`` with a bf16/f32 or int8 KV cache,
``decode_step``, ``prefill_cache``).  Where the reference scans over
stacked layer params, the port keeps one param dict and one cache dict
per layer and loops over them.  One NL-ADC activation (the hidden ``silu`` ramp, thresholds on the
model's device) is shared by every layer, and one sigmoid NL-ADC by every
MoE router.

Analog modes: ``exact``; ``infer`` (the ramps and banks programmed once at
build time by the device model: the LM spec carries no weight noise, so a
step draws nothing); ``train`` (fresh ramp-step noise on every call of the
hidden activation, straight-through gradients).  The reference splits one
key per layer inside its scan and hands it to every gate of the layer; the
port draws a layer's ramp noise from the caller's :class:`NoiseSource`
before the layer (:meth:`AnalogActivation.ramp_draws`), so a recompute
under ``remat`` sees the same thresholds.  The router's sigmoid NL-ADC
takes no key: its thresholds are noiseless.

The other families, ``moe_impl="ep_shardmap"`` and ``remat_policy="dots"``
raise ``NotImplementedError`` naming the ``ROADMAP.md`` item that brings
them.  The model lives on the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
from repro_torch.core.crossbar import NoiseSource
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
        # the auxiliary NL-ADCs, one chip's ramps shared by every layer:
        # the MoE router's sigmoid, and the softplus and silu that ride in
        # the other families' recurrent cells (programmed, and so aged and
        # re-calibrated by a deployment's lifecycle, as the reference's)
        acfg = AnalogConfig.from_spec(cfg.analog)
        self.sigmoid_act = AnalogActivation("sigmoid", acfg, self.device)
        self.softplus_act = AnalogActivation("softplus", acfg, self.device)
        self.silu_act = AnalogActivation("silu", acfg, self.device)
        # realize the d_ff-wide threshold bank (the MLP gate's output)
        # once, here, rather than inside the first step
        self.act.bank_for(cfg.d_ff)
        self.kv_chunk = 1024       # flash-style attention's KV chunk

    def act_param_leaves(self) -> Dict[str, Tuple[str, ...]]:
        """NL-ADC activation -> keystr fragments of the param leaves whose
        crossbar columns feed it (the reference's spelling, which matches
        both its stacked paths and the port's per-layer ones).

        Only the hidden activation (``act``) maps: it digitizes the MLP
        gate projection's output (width d_ff), so the gate/up matrices of
        every family's MLP and the MoE expert and shared-expert ones are
        the crossbars behind its threshold banks.  A weight refresh that
        another activation triggers re-programs the whole chip.  The
        serving engine reads it for the per-tile weight refresh.
        """
        return {"act": ("['mlp']['wi_gate']['w']", "['mlp']['wi']['w']",
                        "['moe']['w_gate']", "['moe']['w_up']",
                        "['mlp']['wi_up']['w']",
                        "['moe']['shared']['wi_gate']['w']",
                        "['moe']['shared']['wi_up']['w']",
                        "['moe']['shared']['wi']['w']")}

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

    # -- full sequence -----------------------------------------------------

    def _gate_widths(self, kind: str):
        """The output widths of the hidden activation's calls in a block:
        the MLP gate, or the routed experts' gate and the shared experts'
        (one key for both in the reference)."""
        cfg = self.cfg
        if kind == "moe_attn" and cfg.n_shared_experts > 0:
            return (cfg.d_ff, cfg.n_shared_experts * cfg.d_ff)
        return (cfg.d_ff,)

    def _apply_block(self, p, x, kind: str, positions, draws,
                     collect_aux: bool):
        cfg = self.cfg
        h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        x = x + A.self_attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            positions=positions, kv_chunk=self.kv_chunk)
        h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind == "moe_attn":
            out = MOE.moe_apply(
                p["moe"], h, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, act=self.act,
                router_score=cfg.router_score, router_act=self.sigmoid_act,
                draws=draws, return_aux=collect_aux)
            if collect_aux:
                out, aux = out
            return x + out, aux
        return x + mlp_apply(p["mlp"], h, self.mlp_kind, self.act,
                             draws=draws), aux

    def forward(self, params, tokens: torch.Tensor, *,
                noise: Optional[NoiseSource] = None,
                collect_aux: bool = False, remat: bool = False):
        """Full-sequence logits.  tokens: (B, S) -> (B, S, padded_vocab)
        float32, and with ``collect_aux`` the MoE load-balance loss summed
        over layers.  ``noise``: the train-mode ramp draws, one layer
        after another (None: the programmed ramps).  ``remat`` recomputes
        each layer's body in the backward (``remat_policy="full"``, the
        reference's ``nothing_saveable``; ``"none"`` keeps everything);
        the result is the same bits either way."""
        cfg = self.cfg
        if remat and cfg.remat_policy not in ("full", "none"):
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet; "
                f"ROADMAP.md queue A item 3 (what is left of the LM "
                f"forward) brings it")
        x = self.embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, kind in zip(params["layers"], self.layer_kinds()):
            draws = self.act.ramp_draws(noise, self._gate_widths(kind))
            if remat and cfg.remat_policy == "full":
                x, aux = checkpoint(self._apply_block, p, x, kind, positions,
                                    draws, collect_aux, use_reentrant=False)
            else:
                x, aux = self._apply_block(p, x, kind, positions, draws,
                                           collect_aux)
            total_aux = total_aux + aux
        logits = self.logits(params, x)
        if collect_aux:
            return logits, total_aux
        return logits

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             noise: Optional[NoiseSource] = None, remat: bool = True):
        """Next-token cross entropy over ``batch["labels"]`` (-1 = masked),
        plus ``router_aux_coef`` x the load-balance loss for a MoE.
        Returns ``(total, metrics)``: ``loss``, ``aux_loss`` and
        ``tokens``, the true count of valid labels (0 for an all-masked
        batch; only the division is clamped)."""
        cfg = self.cfg
        moe = cfg.family == "moe"
        out = self.forward(params, batch["tokens"], noise=noise,
                           collect_aux=moe, remat=remat)
        logits, aux = out if moe else (out, torch.zeros(
            (), dtype=torch.float32, device=out.device))
        labels = batch["labels"]
        valid = labels >= 0
        safe = torch.clamp_min(labels, 0).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        n_valid = torch.sum(valid)
        loss = torch.sum(nll) / torch.clamp_min(n_valid, 1)
        total = loss + cfg.router_aux_coef * aux
        return total, {"loss": loss, "aux_loss": aux,
                       "tokens": n_valid.to(torch.float32)}

    def prefill(self, params, tokens: torch.Tensor, *,
                noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """Forward a prompt, returning the last position's logits (B, 1,
        V); no cache is written (the cache-writing prefill is
        :meth:`prefill_cache`)."""
        return self.forward(params, tokens, noise=noise)[:, -1:]

    def prefill_cache(self, params, state, tokens, valid_len):
        """Cache-writing chunked and batched prefill (see
        :func:`repro_torch.nn.model.prefill_cache`: the decode path with
        per-row length masking and the shared global index)."""
        from repro_torch.nn import model as M

        return M.prefill_cache(self, params, state, tokens, valid_len)

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
