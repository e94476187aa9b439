"""The dense family's remaining configs: granite-3-8b (tied embeddings,
vocab 49,155), qwen2.5-32b (QKV bias, G 5), pixtral-12b (H x head_dim
4,096 against d_model 5,120, vision patch embeddings over the first
positions) and granite-34b (MQA, the plain gelu MLP), held against the JAX
package at their SMOKE widths, float32, with the same weights through
``lm_params_from_jax`` and numpy-seeded tokens and labels.

* ``CONFIG`` and ``SMOKE`` equal the reference's field for field, and
  ``n_params`` is ``tests/test_configs.py``'s pinned figure.
* ``LM.forward`` and ``LM.loss`` in exact, infer (``paper-infer``) and
  train mode (``paper``: the reference's per-layer ramp draws replayed)
  against ``jax.jit`` of the reference's (``test_torch_lm_forward``'s
  ``_check``).
* pixtral's patch embeddings, the decode path, the kernels' semantics
  and the train launcher: ``tests/test_torch_dense_decode.py``.

Criteria, as the JAX package's ``test_model_family_parity``: logits within
LSB/2 of the config's ramp (silu 0.102, gelu 0.068); the loss within rtol
1e-6.  One model pair per (arch, mode, ...) is built and shared.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.nn.model import build as tbuild
from test_configs import N_PARAMS_PIN
from test_torch_lm_forward import _check

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ARCHS = ("granite-3-8b", "qwen2.5-32b", "pixtral-12b", "granite-34b")


@functools.lru_cache(maxsize=None)
def models(arch, mode, *, jbk="ref", tbk="ref", kv="bfloat16"):
    """(JAX model, JAX params, port model, port params) of one SMOKE config
    in float32, the config's own ramp in ``mode``."""
    base = JC.get_smoke(arch)
    spec = dict(enabled=True, adc_bits=5, activation=base.analog.activation,
                mode=mode,
                device="paper-infer" if mode == "infer" else "paper")
    jcfg = base.replace(dtype="float32", kv_cache_dtype=kv,
                        analog=JSpec(backend=jbk, **spec))
    tcfg = TC.get_smoke(arch)
    tcfg = tcfg.replace(dtype="float32", kv_cache_dtype=kv,
                        analog=dataclasses.replace(tcfg.analog, backend=tbk,
                                                   **spec))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch, smoke):
    get_j, get_t = (JC.get_smoke, TC.get_smoke) if smoke \
        else (JC.get, TC.get)
    want, got = get_j(arch), get_t(arch)
    assert arch in TC.ARCH_NAMES
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab == want.padded_vocab
    if not smoke:
        assert (got.n_params(), got.n_active_params()) == N_PARAMS_PIN[arch]


def test_the_configs_new_cases():
    """What these configs bring to the dense path: tied embeddings over a
    padded vocab, H x head_dim != d_model, the plain MLP under MQA."""
    g8, px, g34 = (TC.get(a) for a in ("granite-3-8b", "pixtral-12b",
                                       "granite-34b"))
    assert g8.tie_embeddings and (g8.vocab, g8.padded_vocab) \
        == (49155, 49664)
    assert px.n_heads * px.head_dim == 4096 != px.d_model
    assert px.modality == "vision" and px.n_patches == 256
    assert g34.n_heads // g34.n_kv_heads == 48
    _, _, tm, tp = models("granite-34b", "exact")
    assert tm.mlp_kind == "plain" and set(tp["layers"][0]["mlp"]) \
        == {"wi", "wo"}
    _, _, tm, tp = models("granite-3-8b", "exact")
    assert "lm_head" not in tp
    _, _, tm, tp = models("pixtral-12b", "exact")
    assert tuple(tp["layers"][0]["attn"]["wo"]["w"].shape) == (
        tm.cfg.n_heads * tm.cfg.head_dim, tm.cfg.d_model)


@pytest.mark.parametrize("mode", ["exact", "infer", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, mode):
    _check(*models(arch, mode))
