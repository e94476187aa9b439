"""ModelConfig schema and the registry of the ported configs.

Each config is one ``<id>.py`` module in this package exposing ``CONFIG``
(exact published numbers) and ``SMOKE`` (a reduced same-family variant).
The schema is the JAX package's, field for field, so one configuration
means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AnalogSpec:
    """Per-model NL-ADC deployment knobs (the paper's technique)."""

    enabled: bool = True
    adc_bits: int = 5
    input_bits: Optional[int] = None   # PWM input quantization off for LMs
    mode: str = "exact"                # exact | train | infer
    # Which nonlinearity gets the NL-ADC treatment (must be in the registry).
    # Empty string -> use the model's hidden_act.
    activation: str = ""
    # Analog execution backend: "" = auto (REPRO_TORCH_BACKEND env, else
    # "ref"); "ref" = plain torch; "cuda" = the hand-written kernels
    # (repro_torch.core.backend).
    backend: str = ""
    # Device-model preset name (repro_torch.core.device registry: "ideal",
    # "paper", "paper-infer", "aged-1day", "stressed", or custom-registered).
    # "" = auto (REPRO_DEVICE env, else "paper").  Kept as a *name* here so
    # ModelConfig stays a plain published-numbers record; AnalogConfig
    # resolves it to the DeviceModel tree.
    device: str = ""
    # Threshold banks: output columns served by one physical NL-ADC ramp
    # (one ramp generator per crossbar col-tile).  0 = single shared ramp
    # per activation (legacy (P,) layout); e.g. 512 = the paper's tile
    # width, giving a (n_col_tiles, P) bank for matrices wider than a tile.
    bank_cols: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Published numbers only — no silent rescaling."""

    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | lstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    hidden_act: str = "silu"
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.0
    router_aux_coef: float = 0.001
    router_score: str = "softmax"   # softmax | sigmoid (moonlight-style)
    moe_impl: str = "gspmd"         # gspmd | ep_shardmap (§Perf iteration)
    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window: int = 0                        # local-attention window (0 = global)
    lru_width: int = 0
    # §Perf C2/C3: recurrence-scan precision and chunking (0 = plain scan)
    lru_scan_dtype: str = "float32"
    lru_chunk: int = 0
    # Griffin's gates are BLOCK-DIAGONAL (one block per head); 0 = dense
    # (the unfaithful ablation kept for the §Perf before/after).
    lru_gate_blocks: int = 0
    # §Perf C5: Megatron-style sequence parallelism — the residual stream
    # is sequence-sharded over the model axis between blocks (AG -> block
    # -> RS replaces the partial-sum all-reduce; norms/elementwise run on
    # 1/model_degree of the tokens).
    sequence_parallel: bool = False
    # Activation-checkpoint policy for the layer scan: "full" recomputes
    # everything (min memory), "dots" saves matmul outputs, "none" saves all.
    remat_policy: str = "full"
    # --- ssm (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_len: int = 1500                    # stub frontend frames
    max_position: int = 32768              # learned-pos-table size (encdec)
    # --- modality frontend stub ---
    modality: str = "text"                 # text | audio | vision
    n_patches: int = 0                     # vision: patch-embedding positions
    # --- lstm (the paper's own models) ---
    lstm_hidden: int = 0
    lstm_proj: int = 0
    n_input_features: int = 0
    n_classes: int = 0
    # --- analog / NL-ADC ---
    analog: AnalogSpec = dataclasses.field(default_factory=AnalogSpec)
    # --- numerics / padding ---
    dtype: str = "bfloat16"
    # Serving-time param storage: cast-at-load for decode/prefill (standard
    # deployment practice; f32 master weights exist only in training).
    serve_params_dtype: str = "float32"
    # §Perf B3: KV-cache storage dtype ("int8" = per-token-per-head
    # symmetric quantization with bf16 scales; dequant fuses into the
    # attention dot on TPU).
    kv_cache_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 512

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return math.ceil(self.vocab / m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the 524k-token decode cell."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch decodes (whisper via its decoder)

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        if self.family == "lstm":
            n_in = self.n_input_features + (self.lstm_proj or self.lstm_hidden)
            p = n_in * 4 * self.lstm_hidden
            if self.lstm_proj:
                p += self.lstm_hidden * self.lstm_proj
            p += (self.lstm_proj or self.lstm_hidden) * self.n_classes
            return p
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            att = 2 * d * (self.q_dim + self.kv_dim + self.q_dim)  # self+x-attn q,o
            blk = att + 2 * d * ff  # gelu mlp (2 mats)
            return emb + (self.n_enc_layers + self.n_dec_layers) * blk
        att = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        mlp = 3 * d * ff
        if self.family == "moe":
            mlp = (self.n_experts + self.n_shared_experts) * 3 * d * ff \
                + d * self.n_experts
        if self.family == "ssm":
            # in_proj packs [z, x] (2*din) plus B/C/dt rows (d_state- and
            # head-sized, negligible at these widths); out_proj din*d;
            # per-head dt_bias/a_log/d_skip ~ din/headdim.
            din = self.ssm_expand * d
            blk = 2 * d * din + din * d + d * (din // self.ssm_headdim)
            return emb + self.n_layers * blk
        if self.family == "hybrid":
            w = self.lru_width or d
            rec = d * w * 3 + w * d + 2 * w  # gates + in/out proj + lru params
            n_rec = sum(1 for b in self._pattern() if b == "rec")
            n_att = self.n_layers - n_rec
            return emb + n_att * (att + mlp) + n_rec * (rec + mlp)
        return emb + self.n_layers * (att + mlp)

    def n_active_params(self) -> int:
        """Active (per-token) params — differs from n_params for MoE."""
        if self.family != "moe":
            return self.n_params()
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        att = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        mlp_active = (self.top_k + self.n_shared_experts) * 3 * d * ff \
            + d * self.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (att + mlp_active)

    def _pattern(self) -> Tuple[str, ...]:
        """Full per-layer block-type sequence."""
        if self.family == "hybrid" and self.block_pattern:
            reps = math.ceil(self.n_layers / len(self.block_pattern))
            return (self.block_pattern * reps)[: self.n_layers]
        return ("attn",) * self.n_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# The paper's two LSTM workloads, the dense LMs (pixtral-12b with its
# vision patch embeddings), the encoder-decoder whisper-base (audio frame
# embeddings), the two MoE LMs and the two recurrent LMs (SSD and RG-LRU).
ARCH_NAMES = ("kws_lstm", "ptb_lstm", "qwen2.5-3b", "granite-3-8b",
              "qwen2.5-32b", "pixtral-12b", "whisper-base", "granite-34b",
              "moonshot-v1-16b-a3b", "deepseek-moe-16b", "mamba2-370m",
              "recurrentgemma-9b")

_MODULE_FOR = {n: "repro_torch.configs." + n.replace("-", "_")
               .replace(".", "_") for n in ARCH_NAMES}


def _load(name: str):
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown config {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_MODULE_FOR[name])


def get(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _load(name).SMOKE
