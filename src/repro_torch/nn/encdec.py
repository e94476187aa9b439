"""Encoder-decoder transformer: whisper-base, the audio family.

The JAX package's ``repro/nn/encdec.py``.  The conv/mel frontend is a stub:
the model takes precomputed frame embeddings ``frames`` (B, T_enc,
d_model) (:func:`repro_torch.nn.frontends.audio_frame_stub`).  Sinusoidal
positions on the encoder, a learned position table (``pos_dec``,
``max_position`` rows) on the decoder, pre-LN blocks with biased Q/K/V,
plain gelu MLPs whose gate goes through the NL-ADC (kernel 3 on the
``cuda`` backend), and a tied readout.  The reference's semantics are kept
where they differ from OpenAI's Whisper: the decoder's self-attention
applies RoPE on top of ``pos_dec``, a decode step past the table's end
reads its last row (``dynamic_slice`` clamps), and the decode cache is the
compute dtype whatever ``kv_cache_dtype`` says.

Where the reference scans over the stacked ``enc_layers`` and
``dec_layers``, the port keeps one param dict a layer in each list, as
:class:`~repro_torch.nn.transformer.LM` does for ``layers``.  The decode
state is ``index`` (the shared position, a Python int), ``self`` (one KV
cache a decoder layer, written in place) and ``cross`` (one ``{"k", "v"}``
of the encoder output a decoder layer: zeros until :meth:`EncDecLM.
start_decode` fills them, as the reference's ``cross_k`` / ``cross_v``).
The decoder's cached self-attention goes through the analog backend's
``prefill_attention`` with ``cfg.analog.backend`` (kernel 5 on ``cuda``),
as ``LM`` passes it; the reference's ``EncDecLM`` passes no backend there
and so takes ``REPRO_ANALOG_BACKEND``'s (``ref`` by default), whose
results agree under the attention contract.

Train mode: the reference hands the forward's one key, unsplit, to every
layer's MLP in both stacks, so every gate call of one threshold shape
sees one draw.  The port draws through one
:class:`~repro_torch.core.analog_layer.RampDraws` a forward.  ``remat`` is
ignored, as in the reference.  The model lives on the GPU unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analog_layer import RampDraws
from repro_torch.core.crossbar import NoiseSource
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn.mlp import make_activation, mlp_apply, mlp_init
from repro_torch.nn.transformer import _model_device, next_token_loss


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position embedding (a host-side constant)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class EncDecLM:
    """whisper's encoder-decoder for one ``family="encdec"``
    :class:`ModelConfig`, its activation ramp on ``device`` (default
    ``cuda``)."""

    # decode-state blocks that a decode step reads and never writes
    read_only_kinds = ("cross",)

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM takes family 'encdec', got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = _model_device(device)
        self.compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32
        self.mlp_kind = "plain"
        self.act = make_activation(cfg, self.device)      # the MLP's NL-ADC
        self.act.bank_for(cfg.d_ff)
        self.kv_chunk = 1024

    # -- init -----------------------------------------------------------

    def _attn_init(self, generator, init=A.attn_init):
        cfg = self.cfg
        return init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, qkv_bias=cfg.qkv_bias)

    def _enc_block_init(self, generator: torch.Generator):
        d, dev = self.cfg.d_model, generator.device
        return {"norm1": L.layernorm_init(d, dev),
                "attn": self._attn_init(generator),
                "norm2": L.layernorm_init(d, dev),
                "mlp": mlp_init(generator, d, self.cfg.d_ff, "plain")}

    def _dec_block_init(self, generator: torch.Generator):
        d, dev = self.cfg.d_model, generator.device
        return {"norm1": L.layernorm_init(d, dev),
                "self_attn": self._attn_init(generator),
                "norm_x": L.layernorm_init(d, dev),
                "cross_attn": self._attn_init(generator, A.cross_attn_init),
                "norm2": L.layernorm_init(d, dev),
                "mlp": mlp_init(generator, d, self.cfg.d_ff, "plain")}

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded float32 params on the generator's device: ``embed``,
        ``pos_dec``, ``enc_layers`` and ``dec_layers`` (lists of per-layer
        dicts), ``enc_norm`` and ``dec_norm``."""
        cfg, dev = self.cfg, generator.device
        return {
            "embed": L.embedding_init(generator, cfg.padded_vocab,
                                      cfg.d_model),
            "pos_dec": 0.01 * torch.randn(
                (cfg.max_position, cfg.d_model), generator=generator,
                device=dev, dtype=torch.float32),
            "enc_layers": [self._enc_block_init(generator)
                           for _ in range(cfg.n_enc_layers)],
            "enc_norm": L.layernorm_init(cfg.d_model, dev),
            "dec_layers": [self._dec_block_init(generator)
                           for _ in range(cfg.n_dec_layers)],
            "dec_norm": L.layernorm_init(cfg.d_model, dev),
        }

    def _mlp(self, p, h, draws):
        return mlp_apply(p, h, "plain", self.act, draws=draws)

    # -- encoder ---------------------------------------------------------

    def encode(self, params, frames: torch.Tensor, *,
               draws: Optional[RampDraws] = None) -> torch.Tensor:
        """frames (B, T_enc, d_model) -> the encoder output in the compute
        dtype."""
        cfg = self.cfg
        pos = torch.from_numpy(sinusoids(frames.shape[1], cfg.d_model)).to(
            frames.device)
        x = (frames + pos[None]).to(self.compute_dtype)
        for lp in params["enc_layers"]:
            h = L.layernorm_apply(lp["norm1"], x)
            x = x + A.bidirectional_attention(
                lp["attn"], h, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                kv_chunk=self.kv_chunk)
            h = L.layernorm_apply(lp["norm2"], x)
            x = x + self._mlp(lp["mlp"], h, draws)
        return L.layernorm_apply(params["enc_norm"], x)

    # -- decoder (full sequence) ------------------------------------------

    def _cross_kv(self, lp, enc_out):
        return A.cross_kv(lp["cross_attn"], enc_out,
                          n_kv_heads=self.cfg.n_kv_heads,
                          head_dim=self.cfg.head_dim)

    def decode_train(self, params, tokens: torch.Tensor,
                     enc_out: torch.Tensor, *,
                     draws: Optional[RampDraws] = None) -> torch.Tensor:
        """Teacher-forced decoder logits (B, S, padded_vocab), float32."""
        cfg = self.cfg
        s = tokens.shape[1]
        if s > params["pos_dec"].shape[0]:
            raise ValueError(f"{s} decoder positions past the position "
                             f"table's {params['pos_dec'].shape[0]}")
        x = L.embedding_apply(params["embed"], tokens,
                              compute_dtype=self.compute_dtype)
        x = x + params["pos_dec"][:s][None].to(x.dtype)
        positions = torch.arange(s, device=tokens.device)[None]
        for lp in params["dec_layers"]:
            h = L.layernorm_apply(lp["norm1"], x)
            x = x + A.self_attention(
                lp["self_attn"], h, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, positions=positions,
                kv_chunk=self.kv_chunk)
            h = L.layernorm_apply(lp["norm_x"], x)
            x = x + A.cross_attention(lp["cross_attn"], h,
                                      self._cross_kv(lp, enc_out),
                                      n_heads=cfg.n_heads,
                                      head_dim=cfg.head_dim,
                                      kv_chunk=self.kv_chunk)
            h = L.layernorm_apply(lp["norm2"], x)
            x = x + self._mlp(lp["mlp"], h, draws)
        x = L.layernorm_apply(params["dec_norm"], x)
        return L.embedding_attend(params["embed"], x)

    # -- the LM's API ------------------------------------------------------

    def forward(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None, *,
                noise: Optional[NoiseSource] = None,
                remat: bool = False) -> torch.Tensor:
        """Logits (B, S, padded_vocab) of ``tokens`` given
        ``extra["frames"]``; ``noise``: the train-mode ramp draws, one
        :class:`RampDraws` shared by every layer of both stacks."""
        draws = None if noise is None else RampDraws(noise)
        enc_out = self.encode(params, extra["frames"], draws=draws)
        return self.decode_train(params, tokens, enc_out, draws=draws)

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             noise: Optional[NoiseSource] = None, remat: bool = True):
        """Next-token cross entropy over ``batch["labels"]`` (-1 = masked)
        given ``batch["frames"]``.  Returns ``(loss, {"loss", "tokens"})``,
        ``tokens`` the true count of valid labels."""
        logits = self.forward(params, batch["tokens"],
                              {"frames": batch["frames"]}, noise=noise)
        loss, n_valid = next_token_loss(logits, batch["labels"])
        return loss, {"loss": loss, "tokens": n_valid.to(torch.float32)}

    def prefill(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None, *,
                noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """The last position's logits (B, 1, V); writes no cache."""
        return self.forward(params, tokens, extra, noise=noise)[:, -1:]

    def prefill_cache(self, params, state, tokens, valid_len):
        """Cache-writing chunked and batched decoder prefill
        (:func:`repro_torch.nn.model.prefill_cache`); the cross K/V ride
        along untouched."""
        from repro_torch.nn import model as M

        return M.prefill_cache(self, params, state, tokens, valid_len)

    # -- decode path -------------------------------------------------------

    def init_decode_state(self, batch: int, max_len: int) -> Dict:
        """``index``, ``self`` (a ``max_len``-slot K/V cache a decoder
        layer, in the compute dtype) and ``cross`` (zero K/V of
        ``enc_len`` frames a decoder layer), each leaf's batch on axis 0,
        on the model's device."""
        cfg = self.cfg
        shape = (batch, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.compute_dtype,
                               device=self.device)

        n = cfg.n_dec_layers
        return {"index": 0,
                "self": [A.init_cache(batch, max_len, cfg.n_kv_heads,
                                      cfg.head_dim, dtype=self.compute_dtype,
                                      device=self.device) for _ in range(n)],
                "cross": [{"k": zeros(), "v": zeros()} for _ in range(n)]}

    def blocks(self, state) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
        """``(kind, leaves)`` of a decode state's blocks: each decoder
        layer's KV cache (``attn``), then its cross K/V (``cross``)."""
        return [("attn", c) for c in state["self"]] \
            + [("cross", c) for c in state["cross"]]

    def written_slot(self, kind: str, index: int, slots: int):
        """The cache slot a decode step at ``index`` writes in place in a
        block of ``kind``; None for the cross K/V, which it only reads."""
        return A.cache_slot(index, slots) if kind == "attn" else None

    def start_decode(self, params, state: Dict, frames: torch.Tensor, *,
                     noise: Optional[NoiseSource] = None) -> Dict:
        """Encode ``frames`` and return ``state`` with its cross K/V those
        of the encoder output, in the compute dtype."""
        draws = None if noise is None else RampDraws(noise)
        enc_out = self.encode(params, frames, draws=draws)
        cross = []
        for lp in params["dec_layers"]:
            k, v = self._cross_kv(lp, enc_out)
            cross.append({"k": k.to(self.compute_dtype),
                          "v": v.to(self.compute_dtype)})
        return dict(state, cross=cross)

    def decode_step(self, params, state: Dict, tokens: torch.Tensor):
        """One decode step.  tokens: (B, 1) -> (logits (B, 1, V), new
        state); the self-attention caches are written in place."""
        cfg = self.cfg
        index = state["index"]
        x = L.embedding_apply(params["embed"], tokens,
                              compute_dtype=self.compute_dtype)
        row = min(index, params["pos_dec"].shape[0] - 1)
        x = x + params["pos_dec"][row:row + 1][None].to(x.dtype)
        new_self = []
        for lp, cache_l, cross_l in zip(params["dec_layers"], state["self"],
                                        state["cross"]):
            h = L.layernorm_apply(lp["norm1"], x)
            y, cache_l = A.decode_self_attention(
                lp["self_attn"], h, cache_l, index, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, analog_backend=cfg.analog.backend)
            new_self.append(cache_l)
            x = x + y
            h = L.layernorm_apply(lp["norm_x"], x)
            x = x + A.cross_attention(lp["cross_attn"], h,
                                      (cross_l["k"], cross_l["v"]),
                                      n_heads=cfg.n_heads,
                                      head_dim=cfg.head_dim,
                                      kv_chunk=self.kv_chunk)
            h = L.layernorm_apply(lp["norm2"], x)
            x = x + self._mlp(lp["mlp"], h, None)
        x = L.layernorm_apply(params["dec_norm"], x)
        logits = L.embedding_attend(params["embed"], x)
        return logits, dict(state, index=index + 1, self=new_self)
