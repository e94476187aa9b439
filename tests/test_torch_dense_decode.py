"""The dense family's remaining configs beyond the full-sequence
forward (``tests/test_torch_dense_configs.py`` holds the configs and
``LM.forward`` / ``LM.loss``), held against the JAX package at their SMOKE
widths, float32, with the same weights through ``lm_params_from_jax``:

* pixtral-12b's forward, loss and prefill with JAX-drawn patch
  embeddings over its first ``n_patches`` positions, and the port's stub
  frontend;
* eight ``decode_step``s of a batch of 2 (``test_torch_lm``'s
  ``_decode_diff``) for each config, and granite-34b's with an int8 KV
  cache;
* granite-34b through the cuda backend's code on the CPU (the kernels'
  plain versions) against the JAX ``pallas`` backend (interpret mode);
* ``launch.train --arch pixtral-12b --smoke`` runs a step.

Criteria as the JAX package's ``test_model_family_parity``: logits within
LSB/2 of the config's ramp (silu 0.102, gelu 0.068); the loss within rtol
1e-6.  Split from the configs' file to keep each file's time short.
"""

import jax
import numpy as np
import pytest
import torch

from repro.nn.frontends import vision_patch_stub as j_patches
from repro_torch.launch import train as TTRAIN
from repro_torch.nn import frontends as TF
from test_torch_dense_configs import ARCHS, models
from test_torch_lm import _decode_diff
from test_torch_lm_forward import (B, KERNELS_ON_CPU, LOSS_RTOL, S, _check,
                                   batch, noise_for, tbatch)

import _torch_threads  # noqa: E402,F401  (one intra-op thread)


def _vision_batch(cfg):
    b = batch(cfg)
    pe = np.asarray(j_patches(jax.random.PRNGKey(7), B, cfg.n_patches,
                              cfg.d_model))
    return b, pe


@pytest.mark.parametrize("mode", ["exact", "infer", "train"])
def test_pixtral_patch_embeds_match_jax(mode):
    """The JAX stub's patch embeddings over the first n_patches positions,
    fed to both packages: logits within LSB/2, the loss within rtol 1e-6,
    and the patches change the logits there."""
    jm, jp, tm, tp = models("pixtral-12b", mode)
    b, pe = _vision_batch(jm.cfg)
    key = jax.random.PRNGKey(5)
    jb = {**b, "patch_embeds": pe}
    (jl, _), jlog = jax.jit(lambda p, bb, k: (
        jm.loss(p, bb, key=k, remat=False),
        jm.forward(p, bb["tokens"], {"patch_embeds": bb["patch_embeds"]},
                   key=k)))(jp, jb, key)
    tb = {**tbatch(b), "patch_embeds": torch.tensor(pe)}
    tl, tmet = tm.loss(tp, tb, noise=noise_for(tm, key), remat=False)
    tlog = tm.forward(tp, tb["tokens"], {"patch_embeds": tb["patch_embeds"]},
                      noise=noise_for(tm, key))
    assert tlog.shape == (B, S, tm.cfg.padded_vocab)
    diff = float(np.max(np.abs(np.asarray(jlog) - tlog.detach().numpy())))
    assert diff < jm.act.ramp.lsb / 2, diff
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    assert float(tmet["tokens"]) == B * S - 3
    text = tm.forward(tp, tb["tokens"], noise=noise_for(tm, key))
    n = tm.cfg.n_patches
    assert not torch.equal(text[:, :n], tlog[:, :n])
    prefill = tm.prefill(tp, tb["tokens"],
                         {"patch_embeds": tb["patch_embeds"]},
                         noise=noise_for(tm, key))
    assert torch.equal(prefill, tlog[:, -1:])


def test_patch_embeds_stub_and_its_limit():
    """The port's stub draws (B, n_patches, d_model) unit-variance
    embeddings from its generator, seed for seed; more patches than
    positions raise, as the reference's negative pad does."""
    gen = torch.Generator().manual_seed(7)
    a = TF.vision_patch_stub(gen, 2, 4, 64)
    b = TF.vision_patch_stub(torch.Generator().manual_seed(7), 2, 4, 64)
    assert a.shape == (2, 4, 64) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert TF.audio_frame_stub(gen, 1, 3, 8).shape == (1, 3, 8)
    _, _, tm, tp = models("pixtral-12b", "exact")
    toks = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="patch embeddings"):
        tm.forward(tp, toks, {"patch_embeds": torch.zeros(1, 4, 64)})


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    jm, jp, tm, tp = models(arch, "exact")
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_mqa_decode_with_int8_cache_matches_jax():
    jm, jp, tm, tp = models("granite-34b", "exact", kv="int8")
    state = tm.init_decode_state(2, 4)
    assert state["layers"][0]["k"].dtype == torch.int8
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_mqa_gelu_kernel_semantics_match_jax_pallas():
    """granite-34b in infer mode: the plain MLP's gelu gate and the MQA
    attention through the cuda backend's Functions and wrappers (their
    plain versions on the CPU) against the JAX pallas backend, forward,
    loss and decode."""
    jm, jp, tm, tp = models("granite-34b", "infer", jbk="pallas",
                            tbk=KERNELS_ON_CPU)
    for p in jax.tree_util.tree_leaves(tp):
        p.requires_grad_(True)             # through the Functions
    _check(jm, jp, tm, tp)
    for p in jax.tree_util.tree_leaves(tp):
        p.requires_grad_(False)
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_train_launcher_runs_pixtral():
    out = TTRAIN.main(["--arch", "pixtral-12b", "--smoke", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "16"])
    assert out["arch"] == "pixtral-12b-smoke" and out["steps"] == 1
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
