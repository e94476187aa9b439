"""The dense LM's decode path: repro_torch's ``LM.decode_step`` against the
JAX package's (under ``jax.jit``, as its serving engine runs it), at the
qwen2.5-3b SMOKE widths (2 layers, d 64, 4 heads over 2 KV heads, ff 160,
vocab 256) in exact analog mode, with the same weights through
``lm_params_from_jax``: 8 steps of a batch of 2.

* ``ref`` against ``ref`` in float32, flat and banked thresholds;
* the kernels' semantics against the JAX ``pallas`` backend (its kernels
  in interpret mode): a test-only backend routes ``matmul_nladc`` and
  ``prefill_attention`` to the port's CPU kernel wrappers.

Criterion, as in the JAX package's ``test_model_family_parity``: max
|delta logits| < LSB/2 of the silu ramp (0.102).  Measured at seed 0:
below 1e-6 in every case (no code flip).

One bfloat16 case: under the default ``--xla_allow_excess_precision=true``
XLA may keep bfloat16 intermediates of a fused chain in float32, so the
reference can round fewer times than an op-by-op evaluation, and one
rounding near a threshold flips an NL-ADC code.  The case runs the
reference with the flag off, in a subprocess (the flag is read once per
process), where it rounds every op as PyTorch does, and holds the logits
to 1e-5.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import backend as TBK
from repro_torch.core.nladc import BankedThresholds
from repro_torch.kernels import fused_matmul_nladc as TFM
from repro_torch.kernels import prefill_attention as TPA
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TTRAIN
from repro_torch.nn import transformer as TM
from repro_torch.nn.encdec import EncDecLM
from repro_torch.nn.model import build as tbuild

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, MAX_LEN = 8, 2, 16
BF16_ATOL = 1e-5


class _KernelsOnCPU(TBK.RefBackend):
    """The ``cuda`` backend's functions through the kernels' CPU wrappers
    (their plain versions), for tensors on the CPU."""

    name = "kernels-cpu"

    def matmul_nladc(self, x, w, adc, bias=None, thresholds=None):
        thr = adc.thresholds if thresholds is None else thresholds
        if isinstance(thr, BankedThresholds):
            thr = thr.per_column
        y = TFM.fused_matmul_nladc(x.reshape(-1, x.shape[-1]), w, bias,
                                   thr, adc.y_table)
        return y.reshape(x.shape[:-1] + (w.shape[-1],))

    def prefill_attention(self, q, k, v, mask):
        m = torch.broadcast_to(mask, (q.shape[0], 1, k.shape[1]))[:, 0]
        return TPA.prefill_attention(q[:, 0].contiguous(), k, v,
                                     m.to(torch.int32))[:, None]


TBK.register_backend(_KernelsOnCPU.name, _KernelsOnCPU())


def _models(dtype, jbk, tbk, bank_cols=0, seed=0):
    jcfg = JC.get_smoke("qwen2.5-3b").replace(
        dtype=dtype, analog=JSpec(enabled=True, adc_bits=5, activation="silu",
                                  backend=jbk, bank_cols=bank_cols))
    tcfg = TC.get_smoke("qwen2.5-3b")
    tcfg = tcfg.replace(dtype=dtype, analog=dataclasses.replace(
        tcfg.analog, backend=tbk, bank_cols=bank_cols))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _decode_diff(jm, jp, tm, tp, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab, (STEPS, BATCH)).astype(np.int32)
    js = jm.init_decode_state(BATCH, MAX_LEN)
    ts = tm.init_decode_state(BATCH, MAX_LEN)
    step = jax.jit(jm.decode_step)
    worst = 0.0
    for t in range(STEPS):
        jl, js = step(jp, js, jnp.asarray(toks[t][:, None]))
        tl, ts = tm.decode_step(
            tp, ts, torch.as_tensor(toks[t][:, None].astype(np.int64)))
        assert tl.shape == (BATCH, 1, tm.cfg.padded_vocab)
        assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
        worst = max(worst, float(np.max(np.abs(np.asarray(jl)
                                               - tl.numpy()))))
    assert ts["index"] == STEPS == int(js["index"])
    return worst


@pytest.mark.parametrize("bank_cols", [0, 64])
def test_ref_matches_jax_ref(bank_cols):
    jm, jp, tm, tp = _models("float32", "ref", "ref", bank_cols)
    assert tm.act.n_banks(tm.cfg.d_ff) == (3 if bank_cols else 1)
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_kernel_semantics_match_jax_pallas():
    jm, jp, tm, tp = _models("float32", "pallas", _KernelsOnCPU.name)
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


_BF16_SCRIPT = """
import json, sys
sys.path.insert(0, {tests!r})
import test_torch_lm as T
jm, jp, tm, tp = T._models("bfloat16", "ref", "ref")
print(json.dumps({{"diff": T._decode_diff(jm, jp, tm, tp)}}))
"""


def test_bf16_ref_matches_jax_ref_rounding_every_op():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c",
         _BF16_SCRIPT.format(tests=str(ROOT / "tests"))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    diff = json.loads(out.stdout.strip().splitlines()[-1])["diff"]
    assert diff <= BF16_ATOL, diff


def test_params_roundtrip_through_npz(tmp_path):
    """``save_npz`` of the JAX tree, then ``load_npz``: every leaf, each
    stacked ``layers`` leaf split per layer."""
    _, jp, tm, _ = _models("float32", "ref", "ref")
    path = tmp_path / "lm.npz"
    convert.save_npz(path, jax.tree_util.tree_map(np.asarray, jp))
    back = convert.load_npz(path)
    assert len(back["layers"]) == tm.cfg.n_layers
    for keys, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in keys]
        want = np.asarray(leaf)
        nodes = [(back, want)] if keys[0] != "layers" else \
            [(back["layers"][i], want[i]) for i in range(tm.cfg.n_layers)]
        for node, w in nodes:
            for k in (keys if keys[0] != "layers" else keys[1:]):
                node = node[k]
            assert torch.equal(node, torch.tensor(w))


def test_init_layout_matches_jax():
    """The port's seeded init gives the JAX tree's shapes, per layer."""
    jm, jp, tm, _ = _models("float32", "ref", "ref")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tm.init(gen)
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape[1:], jp["layers"])
    shapes_t = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                      tp["layers"][0])
    assert shapes_j == shapes_t and len(tp["layers"]) == tm.cfg.n_layers
    assert tp["embed"]["table"].shape == jp["embed"]["table"].shape
    assert "lm_head" not in tp                   # tied embeddings


@pytest.mark.parametrize("what", ["family", "ep_shardmap", "train",
                                  "hybrid_grad_comm"])
def test_outside_the_slice_raises(what):
    """What is not ported raises, naming its ``ROADMAP.md`` item: expert
    parallelism (``moe_impl="ep_shardmap"``), the hybrid's training under
    ``remat_policy="dots"`` (``launch.train --arch recurrentgemma-9b
    --override remat_policy=dots``: its groups are recomputed whole) and
    the hybrid's training under ``--grad-comm hierarchical`` (the
    two-level data-parallel all-reduce).  Every family is ported: the
    decoder-only ``LM`` given the encoder-decoder's config raises, naming
    the ``EncDecLM`` that ``build`` returns for it.  The SSM
    and hybrid families serve, whisper-base serves, trains and deploys
    (tests/test_torch_whisper*.py), the rolling-window cache and its int8
    fallback with them (tests/test_torch_lm_recurrent.py), and train
    (tests/test_torch_lm_recurrent_train.py); the dense and MoE int8
    caches (tests/test_torch_moe.py, tests/test_torch_flash_decode.py),
    and the infer and train modes (tests/test_torch_lm_forward.py) are
    ported."""
    if what == "family":
        with pytest.raises(ValueError, match="EncDecLM"):
            TM.LM(TC.get_smoke("whisper-base"), device="cpu")
        assert isinstance(tbuild(TC.get_smoke("whisper-base"),
                                 device="cpu"), EncDecLM)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "train":
            TTRAIN.main(["--arch", "recurrentgemma-9b", "--smoke",
                         "--device", "cpu", "--steps", "1", "--override",
                         "remat_policy=dots"])
        elif what == "hybrid_grad_comm":
            TTRAIN.main(["--arch", "recurrentgemma-9b", "--smoke",
                         "--device", "cpu", "--steps", "1", "--grad-comm",
                         "hierarchical"])
        else:
            cfg = TC.get_smoke("moonshot-v1-16b-a3b").replace(
                moe_impl="ep_shardmap")
            tbuild(cfg, device="cpu").init_decode_state(1, 4)


def test_build_defaults_to_the_gpu(monkeypatch):
    """``build`` and ``LM`` put the model on ``cuda`` unless asked for the
    CPU, and raise without a GPU rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild(cfg)
    assert tbuild(cfg, device="cpu").device == torch.device("cpu")
