"""The LM's full-sequence path: repro_torch's ``LM.forward`` / ``LM.loss``
/ ``LM.prefill`` against the JAX package's under ``jax.jit``, at the SMOKE
widths of qwen2.5-3b (dense), moonshot-v1-16b-a3b (MoE, sigmoid router)
and deepseek-moe-16b (MoE, softmax router), float32, with the same weights
through ``lm_params_from_jax`` and numpy-seeded tokens and labels (three
labels masked with -1).

* ``exact``, ``infer`` (the ``paper-infer`` preset's programmed ramps and
  banks: ``paper`` has no build stage, so infer mode on it is exact mode)
  and ``train`` (the ``paper`` preset's ramp-step noise): in train mode
  the port replays the reference's draws, ``normal(k_layer, shape)`` with
  ``k, k_layer = split(k)`` per layer, one draw per distinct threshold
  shape of the layer (:class:`RampDraws`).  Flat thresholds and banks
  (64 columns for qwen's d_ff 160: 3 banks; 16 for the MoE's 32: 2).
* ``decode_step`` in infer and train mode, 8 steps of a batch of 2, as
  ``tests/test_torch_lm.py`` runs exact mode.
* The kernels' semantics: a test-only backend runs the ``cuda`` backend's
  code (its autograd Functions and the kernel wrappers, which take their
  plain versions on the CPU) against the JAX ``pallas`` backend, whose
  kernels run in interpret mode.

Criteria: logits within LSB/2 of the silu ramp (0.102), as the JAX
package's ``test_model_family_parity`` holds its backends; measured below
2.2e-6 in every case, no code flip.  The loss, the aux loss and the token
count within rtol 1e-6 (a few float32 ulps: the log-softmax sums in
another order).  ``SyntheticLM.batch_at`` is bitwise the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import backend as TBK
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.nn.model import build as tbuild

ARCHS = ("qwen2.5-3b", "moonshot-v1-16b-a3b", "deepseek-moe-16b")
BANK_COLS = {"qwen2.5-3b": 64, "moonshot-v1-16b-a3b": 16,
             "deepseek-moe-16b": 16}
B, S = 2, 12
LOSS_RTOL = 1e-6


# the cuda backend's code on CPU tensors: its Functions, and the kernel
# wrappers' plain versions
KERNELS_ON_CPU = "cuda-on-cpu"
TBK.register_backend(KERNELS_ON_CPU, TBK.CudaBackend("cpu"))


def models(arch, mode, bank_cols=0, *, jbk="ref", tbk="ref",
           dtype="float32", seed=0):
    """(JAX model, JAX params, port model, port params) on one config."""
    spec = dict(enabled=True, adc_bits=5, activation="silu", mode=mode,
                device="paper-infer" if mode == "infer" else "paper",
                bank_cols=bank_cols)
    jcfg = JC.get_smoke(arch).replace(dtype=dtype,
                                      analog=JSpec(backend=jbk, **spec))
    tcfg = TC.get_smoke(arch)
    tcfg = tcfg.replace(dtype=dtype, analog=dataclasses.replace(
        tcfg.analog, backend=tbk, **spec))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def draws(tm, key):
    """The reference's per-layer ramp draws in the port's order."""
    out, k = [], key
    for kind in tm.layer_kinds():
        k, k_layer = jax.random.split(k)
        shapes = []
        cfg = tm.cfg
        widths = (cfg.d_ff, cfg.n_shared_experts * cfg.d_ff) \
            if kind == "moe_attn" and cfg.n_shared_experts > 0 \
            else (cfg.d_ff,)
        for width in widths:
            shape = tm.act._ramp_shape(width)
            if shape not in shapes:
                shapes.append(shape)
                out.append(np.asarray(jax.random.normal(k_layer, shape,
                                                        jnp.float32)))
    return out


def batch(cfg, seed=0):
    """numpy tokens and labels, (B, S) int32, three labels masked."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


def tbatch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def noise_for(tm, key):
    return ReplayNoise(draws(tm, key)) \
        if tm.cfg.analog.mode == "train" else None


def _check(jm, jp, tm, tp, key=jax.random.PRNGKey(5)):
    b = batch(jm.cfg)
    (jl, jmet), jlog = jax.jit(lambda p, bb, k: (
        jm.loss(p, bb, key=k, remat=False),
        jm.forward(p, bb["tokens"], key=k)))(jp, b, key)
    noise = noise_for(tm, key)
    tl, tmet = tm.loss(tp, tbatch(b), noise=noise, remat=False)
    assert noise is None or noise.remaining == 0
    noise = noise_for(tm, key)
    tlog = tm.forward(tp, tbatch(b)["tokens"], noise=noise)
    assert tlog.shape == (B, S, tm.cfg.padded_vocab)
    assert tlog.dtype == torch.float32 and torch.isfinite(tlog).all()
    diff = float(np.max(np.abs(np.asarray(jlog) - tlog.detach().numpy())))
    assert diff < jm.act.ramp.lsb / 2, diff
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(tmet["tokens"]) == B * S - 3
    return diff


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("mode", ["exact", "infer", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, mode, banked):
    bank_cols = BANK_COLS[arch] if banked else 0
    jm, jp, tm, tp = models(arch, mode, bank_cols)
    assert tm.act.n_banks(tm.cfg.d_ff) == (
        -(-tm.cfg.d_ff // bank_cols) if banked else 1) > (1 if banked else 0)
    _check(jm, jp, tm, tp)


@pytest.mark.parametrize("mode", ["infer", "train"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b"])
def test_kernel_semantics_match_jax_pallas(arch, mode):
    """The cuda backend's Functions (the gate, the expert gate, the
    router's NL-ADC), their kernels' plain versions on the CPU, against
    the JAX pallas backend in interpret mode."""
    jm, jp, tm, tp = models(arch, mode, jbk="pallas",
                            tbk=KERNELS_ON_CPU)
    for p in jax.tree_util.tree_leaves(tp):
        p.requires_grad_(True)             # through the Functions
    _check(jm, jp, tm, tp)


@pytest.mark.parametrize("mode", ["infer", "train"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b"])
def test_decode_matches_jax(arch, mode):
    """``decode_step`` in infer mode (programmed ramps) and train mode
    (the ideal ramps: the reference's engine passes no key there)."""
    from test_torch_lm import _decode_diff

    jm, jp, tm, tp = models(arch, mode)
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_prefill_is_the_last_position():
    jm, jp, tm, tp = models("qwen2.5-3b", "exact")
    toks = tbatch(batch(jm.cfg))["tokens"]
    want = jax.jit(jm.prefill)(jp, jnp.asarray(toks.numpy()))
    got = tm.prefill(tp, toks)
    assert got.shape == (B, 1, tm.cfg.padded_vocab)
    assert torch.equal(got, tm.forward(tp, toks)[:, -1:])
    assert float(np.max(np.abs(np.asarray(want) - got.numpy()))) \
        < jm.act.ramp.lsb / 2


def test_all_masked_labels_count_no_token():
    jm, jp, tm, tp = models("moonshot-v1-16b-a3b", "exact")
    b = batch(jm.cfg)
    b["labels"][:] = -1
    total, met = tm.loss(tp, tbatch(b), remat=False)
    _, jmet = jax.jit(lambda p, bb: jm.loss(p, bb, remat=False))(jp, b)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 0.0
    assert float(met["loss"]) == float(jmet["loss"]) == 0.0
    np.testing.assert_allclose(float(total), float(jm.cfg.router_aux_coef
                                                   * jmet["aux_loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("seed,vocab,seq,batch_size",
                         [(0, 256, 12, 2), (3, 151936, 128, 8),
                          (7, 5000, 33, 3)])
def test_synthetic_lm_bitwise(seed, vocab, seq, batch_size):
    jpipe = JSyntheticLM(vocab, seq, batch_size, seed=seed)
    tpipe = SyntheticLM(vocab, seq, batch_size, seed=seed)
    for step in (0, 1, 17):
        want, got = jpipe.batch_at(step), tpipe.batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    for _ in range(2):
        for k, v in tpipe.next_batch().items():
            np.testing.assert_array_equal(v, jpipe.next_batch()[k]
                                          if k == "tokens" else v)
    assert tpipe.state.step == 2
