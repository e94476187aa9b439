"""Decoder-only LM: the dense, MoE, SSM and hybrid families.

The JAX package's ``repro/nn/transformer.py`` for its ``attn``,
``moe_attn``, ``ssd`` and ``rec`` blocks: ``init``, ``embed`` (a vision
config's patch embeddings overwrite the first positions), ``logits``,
``layer_kinds``, the full-sequence ``forward`` / ``loss`` / ``prefill``,
and the decode path (``init_decode_state`` with a bf16/f32 or int8 KV
cache, a rolling-window cache for the hybrid's local attention and the
recurrent states ``ssm``, ``conv`` and ``h``; ``decode_step``,
``prefill_cache``).  Where the reference scans over stacked layer params,
the port keeps one param dict and one cache dict per block and loops over
them.  The dense, MoE and SSM families hold them in the list ``layers``;
the hybrid keeps the reference's own structure: ``groups``, one dict per
``block_pattern`` repeat keyed ``b{i}_{kind}`` (``b0_rec``, ``b1_rec``,
``b2_attn``), and ``tail``, the list of the blocks left over.  One NL-ADC
activation (the hidden ramp, thresholds on the model's device) is shared
by every layer, and one each of the auxiliary sigmoid, softplus and silu
NL-ADCs: the MoE router's sigmoid, SSD's dt softplus and z-gate silu, and
RG-LRU's two sigmoid gates, wired as the reference wires them (the hidden
activation also digitizes RG-LRU's ``W_g`` branch).

Analog modes: ``exact``; ``infer`` (the ramps and banks programmed once at
build time by the device model: the LM spec carries no weight noise, so a
step draws nothing); ``train`` (fresh ramp-step noise on every call of the
hidden activation and of the recurrent cells' NL-ADCs, straight-through
gradients).  The reference splits one key per layer inside its scan (per
group for the hybrid, whose three blocks share it; the tail takes the
forward's own key, unsplit) and hands it to every NL-ADC there.  A draw is
``normal(key, shape)``, so calls of one threshold shape see one draw,
whichever activation makes them.  The port draws a unit's ramp noise from
the caller's :class:`NoiseSource` through one
:class:`~repro_torch.core.analog_layer.RampDraws` a unit (one draw per
distinct shape at its first use, across activations), which a recompute
under ``remat`` reads again, so it sees the same thresholds.  The router's sigmoid NL-ADC takes no key: its thresholds are
noiseless.

Another family raises ``ValueError`` (``nn/model.py::build`` gives the
encoder-decoder its ``EncDecLM``); ``moe_impl="ep_shardmap"`` and
``remat_policy="dots"`` raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings them.  The model lives on the GPU unless
the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig, \
    RampDraws
from repro_torch.core.crossbar import NoiseSource
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as MOE
from repro_torch.nn import rglru as RG
from repro_torch.nn import ssd as SSD
from repro_torch.nn.mlp import make_activation, mlp_apply, mlp_init, \
    mlp_type_for

FAMILIES = ("dense", "moe", "ssm", "hybrid")
ATTENTION_KINDS = ("attn", "moe_attn")


def _model_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; a CUDA device without a GPU
    raises rather than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    return device


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor):
    """The mean cross entropy of ``logits`` over the labels >= 0 (-1 =
    masked) and the count of those labels (only the division is clamped,
    so an all-masked batch counts 0)."""
    valid = labels >= 0
    safe = torch.clamp_min(labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n_valid = torch.sum(valid)
    return torch.sum(nll) / torch.clamp_min(n_valid, 1), n_valid


class LM:
    """A decoder-only language model for one dense, MoE, SSM or hybrid
    :class:`ModelConfig`, its activation ramps on ``device`` (default
    ``cuda``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"LM takes the decoder-only families {FAMILIES}, not "
                f"{cfg.family!r}; repro_torch.nn.model.build returns the "
                f"encoder-decoder's EncDecLM")
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
        # the MoE router's and RG-LRU's gates' sigmoid, and SSD's softplus
        # and silu (programmed, and so aged and re-calibrated by a
        # deployment's lifecycle, as the reference's)
        acfg = AnalogConfig.from_spec(cfg.analog)
        self.sigmoid_act = AnalogActivation("sigmoid", acfg, self.device)
        self.softplus_act = AnalogActivation("softplus", acfg, self.device)
        self.silu_act = AnalogActivation("silu", acfg, self.device)
        # realize the d_ff-wide threshold bank (the MLP gate's output)
        # once, here, rather than inside the first step; other widths (the
        # hybrid's W_g branch) realize at first use from the same keyed
        # draws
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

    def layer_kinds(self) -> Tuple[str, ...]:
        cfg = self.cfg
        if cfg.family == "ssm":
            return ("ssd",) * cfg.n_layers
        if cfg.family == "hybrid":
            return cfg._pattern()
        kind = "moe_attn" if cfg.family == "moe" else "attn"
        return (kind,) * cfg.n_layers

    def _window(self, kind: str) -> int:
        """The local-attention window of a block (the hybrid's attention
        blocks), else 0 (global)."""
        return self.cfg.window if (self.cfg.family == "hybrid"
                                   and kind == "attn") else 0

    def _n_groups(self) -> int:
        return self.cfg.n_layers // len(self.cfg.block_pattern)

    def blocks(self, tree) -> List[Tuple[str, Any]]:
        """``(kind, subtree)`` of every block of a params or decode-state
        tree, in layer order: ``layers``, or the hybrid's ``groups`` (each
        group's ``b{i}_{kind}`` in pattern order) then its ``tail``."""
        if self.cfg.family != "hybrid":
            return list(zip(self.layer_kinds(), tree["layers"]))
        pat = self.cfg.block_pattern
        out = [(kind, g[f"b{i}_{kind}"]) for g in tree["groups"]
               for i, kind in enumerate(pat)]
        tail_kinds = self.layer_kinds()[self._n_groups() * len(pat):]
        return out + list(zip(tail_kinds, tree["tail"]))

    def assemble(self, subtrees: List[Any]) -> Dict[str, Any]:
        """The inverse of :meth:`blocks`: per-block subtrees in layer order
        into ``{"layers": [...]}`` or ``{"groups": [...], "tail": [...]}``."""
        if self.cfg.family != "hybrid":
            return {"layers": list(subtrees)}
        pat = self.cfg.block_pattern
        n = self._n_groups() * len(pat)
        groups = [{f"b{i}_{kind}": subtrees[g * len(pat) + i]
                   for i, kind in enumerate(pat)}
                  for g in range(self._n_groups())]
        return {"groups": groups, "tail": list(subtrees[n:])}

    def _block_init(self, generator: torch.Generator, kind: str):
        cfg = self.cfg
        d = cfg.d_model
        dev = generator.device
        if kind == "ssd":
            return {"norm": L.rmsnorm_init(d, dev),
                    "ssd": SSD.ssd_init(generator, d, expand=cfg.ssm_expand,
                                        headdim=cfg.ssm_headdim,
                                        d_state=cfg.ssm_state,
                                        conv_width=cfg.conv_width)}
        if kind == "rec":
            return {"norm1": L.rmsnorm_init(d, dev),
                    "rec": RG.rglru_init(generator, d, cfg.lru_width or d,
                                         cfg.conv_width,
                                         gate_blocks=cfg.lru_gate_blocks),
                    "norm2": L.rmsnorm_init(d, dev),
                    "mlp": mlp_init(generator, d, cfg.d_ff, self.mlp_kind)}
        blk = {
            "norm1": L.rmsnorm_init(d, dev),
            "attn": A.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, qkv_bias=cfg.qkv_bias),
            "norm2": L.rmsnorm_init(d, dev),
        }
        if kind == "moe_attn":
            blk["moe"] = MOE.moe_init(generator, d, cfg.d_ff, cfg.n_experts,
                                      cfg.n_shared_experts, self.mlp_kind)
        else:
            blk["mlp"] = mlp_init(generator, d, cfg.d_ff, self.mlp_kind)
        return blk

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded float32 params on the generator's device: ``embed``,
        ``final_norm``, ``lm_head`` (untied only), and the blocks as
        ``layers``, a list of per-layer dicts, or the hybrid's ``groups``
        and ``tail`` (:meth:`blocks`)."""
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": L.embedding_init(generator, cfg.padded_vocab,
                                      cfg.d_model),
            "final_norm": L.rmsnorm_init(cfg.d_model, generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                             cfg.padded_vocab)
        params.update(self.assemble([self._block_init(generator, kind)
                                     for kind in self.layer_kinds()]))
        return params

    # -- embedding and readout --------------------------------------------

    def embed(self, params, tokens: torch.Tensor,
              extra: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
        """The token embeddings (B, S, d_model) in the compute dtype; for a
        vision config (``modality == "vision"``) with
        ``extra["patch_embeds"]`` (B, n_patches, d_model), the first
        n_patches positions are those embeddings, cast to the compute
        dtype, as the reference's stub frontend hands them over."""
        x = L.embedding_apply(params["embed"], tokens,
                              compute_dtype=self.compute_dtype)
        if self.cfg.modality == "vision" and extra \
                and "patch_embeds" in extra:
            pe = extra["patch_embeds"].to(x.dtype)
            if pe.shape[1] > x.shape[1]:
                raise ValueError(f"{pe.shape[1]} patch embeddings for "
                                 f"{x.shape[1]} positions")
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            return L.embedding_attend(params["embed"], x)
        return L.dense_apply(params["lm_head"], x,
                             compute_dtype=self.compute_dtype).float()

    # -- full sequence -----------------------------------------------------

    def _apply_block(self, p, x, kind: str, positions, draws,
                     collect_aux: bool):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind == "ssd":
            h = L.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
            return x + SSD.ssd_apply(
                p["ssd"], h, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                d_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                dt_act=self.softplus_act, gate_act=self.silu_act,
                draws=draws), aux
        if kind == "rec":
            h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            x = x + RG.rglru_apply(
                p["rec"], h, self.sigmoid_act, self.act, draws=draws,
                scan_dtype=(torch.bfloat16 if cfg.lru_scan_dtype
                            == "bfloat16" else torch.float32),
                chunk=cfg.lru_chunk)
            h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            return x + mlp_apply(p["mlp"], h, self.mlp_kind, self.act,
                                 draws=draws), aux
        h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        x = x + A.self_attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=self._window(kind), positions=positions,
            kv_chunk=self.kv_chunk)
        h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
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

    def _keyed_units(self, params) -> List[Tuple[list, bool]]:
        """The blocks grouped by the train-mode key they share, in layer
        order, each with whether ``remat`` recomputes it: one layer
        (recomputed), or the hybrid's group (one key for its three
        blocks, recomputed as one) and then its tail (the forward's own
        key for every tail block, never recomputed), as the reference's
        scan and tail loop hand out keys and remat."""
        blocks = self.blocks(params)
        if self.cfg.family != "hybrid":
            return [([blk], True) for blk in blocks]
        n = len(self.cfg.block_pattern)
        n_scanned = self._n_groups() * n
        units = [(blocks[i:i + n], True) for i in range(0, n_scanned, n)]
        if blocks[n_scanned:]:
            units.append((blocks[n_scanned:], False))
        return units

    def _apply_unit(self, ps, x, kinds, positions, draws, collect_aux: bool):
        """The blocks of one keyed unit, one after another, with its
        draws; returns x and the units' aux loss."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, kind in zip(ps, kinds):
            x, a = self._apply_block(p, x, kind, positions, draws,
                                     collect_aux)
            aux = aux + a
        return x, aux

    def forward(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None, *,
                noise: Optional[NoiseSource] = None,
                collect_aux: bool = False, remat: bool = False):
        """Full-sequence logits.  tokens: (B, S) -> (B, S, padded_vocab)
        float32, and with ``collect_aux`` the MoE load-balance loss summed
        over layers.  ``extra``: the modality inputs (:meth:`embed`).
        ``noise``: the train-mode ramp draws, one keyed unit after another
        (:meth:`_keyed_units`; None: the programmed ramps).
        ``remat`` recomputes each layer's body, or each hybrid group's, in
        the backward (``remat_policy="full"``, the reference's
        ``nothing_saveable``; ``"none"`` keeps everything); the result is
        the same bits either way."""
        cfg = self.cfg
        if remat and cfg.remat_policy not in ("full", "none"):
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet; "
                f"ROADMAP.md queue A item 3 (what is left of the LM "
                f"forward) brings it")
        x = self.embed(params, tokens, extra)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for unit, recompute in self._keyed_units(params):
            kinds = tuple(kind for kind, _ in unit)
            ps = [p for _, p in unit]
            # every block of the unit shares the draws; the recompute
            # under remat finds those its forward made
            draws = None if noise is None else RampDraws(noise)
            if remat and recompute and cfg.remat_policy == "full":
                x, aux = checkpoint(self._apply_unit, ps, x, kinds,
                                    positions, draws, collect_aux,
                                    use_reentrant=False)
            else:
                x, aux = self._apply_unit(ps, x, kinds, positions, draws,
                                          collect_aux)
            total_aux = total_aux + aux
        logits = self.logits(params, x)
        if collect_aux:
            return logits, total_aux
        return logits

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             noise: Optional[NoiseSource] = None, remat: bool = True):
        """Next-token cross entropy over ``batch["labels"]`` (-1 = masked),
        plus ``router_aux_coef`` x the load-balance loss for a MoE; every
        other key of ``batch`` goes to :meth:`forward` as ``extra`` (a
        vision config's ``patch_embeds``).  Returns ``(total, metrics)``:
        ``loss``, ``aux_loss`` and ``tokens``, the true count of valid
        labels (0 for an all-masked batch; only the division is
        clamped)."""
        cfg = self.cfg
        moe = cfg.family == "moe"
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        out = self.forward(params, batch["tokens"], extra or None,
                           noise=noise, collect_aux=moe, remat=remat)
        logits, aux = out if moe else (out, torch.zeros(
            (), dtype=torch.float32, device=out.device))
        loss, n_valid = next_token_loss(logits, batch["labels"])
        total = loss + cfg.router_aux_coef * aux
        return total, {"loss": loss, "aux_loss": aux,
                       "tokens": n_valid.to(torch.float32)}

    def prefill(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None, *,
                noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """Forward a prompt, returning the last position's logits (B, 1,
        V); no cache is written (the cache-writing prefill is
        :meth:`prefill_cache`)."""
        return self.forward(params, tokens, extra, noise=noise)[:, -1:]

    def prefill_cache(self, params, state, tokens, valid_len):
        """Cache-writing chunked and batched prefill (see
        :func:`repro_torch.nn.model.prefill_cache`: the decode path with
        per-row length masking and the shared global index)."""
        from repro_torch.nn import model as M

        return M.prefill_cache(self, params, state, tokens, valid_len)

    # -- decode path -------------------------------------------------------

    def _block_cache(self, kind: str, batch: int, max_len: int):
        cfg = self.cfg
        if kind == "ssd":
            return SSD.ssd_init_state(
                batch, cfg.d_model, expand=cfg.ssm_expand,
                headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                conv_width=cfg.conv_width, dtype=self.compute_dtype,
                device=self.device)
        if kind == "rec":
            return RG.rglru_init_state(batch, cfg.lru_width or cfg.d_model,
                                       cfg.conv_width,
                                       dtype=self.compute_dtype,
                                       device=self.device)
        return A.init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                            window=self._window(kind),
                            dtype=self.compute_dtype,
                            quantized=cfg.kv_cache_dtype == "int8",
                            device=self.device)

    def init_decode_state(self, batch: int, max_len: int) -> Dict:
        """``index`` (the shared position, a Python int) and one cache per
        block on the model's device, laid out as the params
        (:meth:`blocks`): K/V for an attention block (int8 codes with
        bfloat16 scales when ``kv_cache_dtype == "int8"``, else the
        compute dtype; a rolling buffer of ``min(max_len, window)`` slots
        for the hybrid's local attention), ``ssm`` and ``conv`` for an SSD
        block, ``h`` and ``conv`` for an RG-LRU block."""
        state = {"index": 0}
        state.update(self.assemble([self._block_cache(kind, batch, max_len)
                                    for kind in self.layer_kinds()]))
        return state

    def written_slot(self, kind: str, index: int, slots: int):
        """The cache slot a decode step at ``index`` writes in place in a
        block of ``kind``, or None where the step replaces the block's
        state whole (the recurrent blocks)."""
        if kind not in ATTENTION_KINDS:
            return None
        return A.cache_slot(index, slots, self._window(kind))

    def _decode_block(self, p, cache_l, x, kind: str, index: int):
        cfg = self.cfg
        if kind == "ssd":
            h = L.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
            y, new = SSD.ssd_decode(
                p["ssd"], h, cache_l, expand=cfg.ssm_expand,
                headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                dt_act=self.softplus_act, gate_act=self.silu_act)
            return x + y, new
        if kind == "rec":
            h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            y, new = RG.rglru_decode(p["rec"], h, cache_l, self.sigmoid_act,
                                     self.act)
            x = x + y
            h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            return x + mlp_apply(p["mlp"], h, self.mlp_kind, self.act), new
        h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        y, new = A.decode_self_attention(
            p["attn"], h, cache_l, index, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=self._window(kind),
            analog_backend=cfg.analog.backend)
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
        state).  The KV caches are updated in place (see
        :func:`repro_torch.nn.attention.decode_self_attention`); the
        recurrent blocks' states are replaced by new tensors."""
        index = state["index"]
        x = self.embed(params, tokens)
        new = []
        for (kind, p), (_, cache_l) in zip(self.blocks(params),
                                           self.blocks(state)):
            x, c = self._decode_block(p, cache_l, x, kind, index)
            new.append(c)
        out = {"index": index + 1}
        out.update(self.assemble(new))
        return self.logits(params, x), out
