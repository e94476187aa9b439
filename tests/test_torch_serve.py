"""The scan-prefill serving engine: repro_torch's ``ServingEngine``
against the JAX package's ``ServingEngine(prefill="scan")`` at the
qwen2.5-3b SMOKE widths in float32, exact mode, ``ref`` backend, with the
same weights (``lm_params_from_jax``) and the same 6 requests (the serve
launchers' ``np.random.default_rng(0)`` prompts), max_batch 4, max_new 8:
the token streams must be identical.  The same for moonshot-v1-16b-a3b
SMOKE (MoE, sigmoid NL-ADC router) with an int8 KV cache, in float32 and
in bfloat16 (the bfloat16 reference with
``--xla_allow_excess_precision=false``, in a subprocess, so it rounds
every op as PyTorch does).  Then the launcher on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import ServingEngine as TEngine

ROOT = Path(__file__).resolve().parents[1]
N_REQ, MAX_BATCH, MAX_NEW, MAX_LEN = 6, 4, 8, 64


def _streams(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    return {r.uid: list(r.generated) for r in reqs}


def _engines(arch, dtype="float32", overrides=None):
    """The JAX and port (model, params) of one SMOKE config, same weights."""
    jcfg = JC.get_smoke(arch).replace(
        dtype=dtype, analog=JSpec(enabled=True, adc_bits=5,
                                  activation="silu", backend="ref"),
        **(overrides or {}))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(arch, smoke=True, backend="ref",
                              overrides=overrides).replace(dtype=dtype)
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _both_streams(arch, dtype="float32", overrides=None):
    jm, jp, tm, tp = _engines(arch, dtype, overrides)
    reqs_t = TSERVE.make_requests(tm.cfg, N_REQ, MAX_NEW)
    reqs_j = [JRequest(uid=r.uid, prompt=r.prompt.copy(),
                       max_new_tokens=r.max_new_tokens) for r in reqs_t]
    want = _streams(JEngine(jm, jp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                            prefill="scan"), reqs_j)
    got = _streams(TEngine(tm, tp, max_batch=MAX_BATCH, max_len=MAX_LEN),
                   reqs_t)
    return {str(k): v for k, v in want.items()}, \
        {str(k): v for k, v in got.items()}


def test_token_streams_match_jax_scan_engine():
    jm, jp, tm, tp = _engines("qwen2.5-3b")
    tcfg = tm.cfg

    reqs_t = TSERVE.make_requests(tcfg, N_REQ, MAX_NEW)
    reqs_j = [JRequest(uid=r.uid, prompt=r.prompt.copy(),
                       max_new_tokens=r.max_new_tokens) for r in reqs_t]
    want = _streams(JEngine(jm, jp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                            prefill="scan"), reqs_j)
    engine = TEngine(tm, tp, max_batch=MAX_BATCH, max_len=MAX_LEN)
    got = _streams(engine, reqs_t)
    assert got == want
    assert all(len(s) == MAX_NEW for s in got.values())
    # every admitted prompt but its last token ran through decode_step
    assert engine.prefill_steps == sum(len(r.prompt) - 1 for r in reqs_t)


_INT8 = {"kv_cache_dtype": "int8"}


def test_moe_int8_token_streams_match_jax_scan_engine():
    want, got = _both_streams("moonshot-v1-16b-a3b", "float32", _INT8)
    assert got == want
    assert all(len(s) == MAX_NEW for s in got.values())


_BF16_SCRIPT = """
import json, sys
sys.path.insert(0, {tests!r})
import test_torch_serve as T
want, got = T._both_streams("moonshot-v1-16b-a3b", "bfloat16", T._INT8)
print(json.dumps({{"want": want, "got": got}}))
"""


def test_moe_int8_token_streams_match_jax_scan_engine_bf16():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c",
         _BF16_SCRIPT.format(tests=str(ROOT / "tests"))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["got"] == res["want"]
    assert all(len(s) == MAX_NEW for s in res["got"].values())


# waves served one after another on one engine: the shared index passes
# max_len, and the cache write lands on the last slot as the reference's
# dynamic_update_slice clamps it
WAVES, WAVE_REQ, WAVE_NEW, WAVE_LEN = 3, 3, 6, 16


def _wave_streams(arch, dtype, overrides=None):
    jm, jp, tm, tp = _engines(arch, dtype, overrides)
    jeng = JEngine(jm, jp, max_batch=2, max_len=WAVE_LEN, prefill="scan")
    teng = TEngine(tm, tp, max_batch=2, max_len=WAVE_LEN)
    want, got = [], []
    for _ in range(WAVES):
        reqs_t = TSERVE.make_requests(tm.cfg, WAVE_REQ, WAVE_NEW)
        reqs_j = [JRequest(uid=r.uid, prompt=r.prompt.copy(),
                           max_new_tokens=r.max_new_tokens) for r in reqs_t]
        want.append({str(k): v for k, v in _streams(jeng, reqs_j).items()})
        got.append({str(k): v for k, v in _streams(teng, reqs_t).items()})
    return want, got, int(teng.state["index"]), int(jeng.state["index"])


_WAVES_SCRIPT = """
import json, sys
sys.path.insert(0, {tests!r})
import test_torch_serve as T
want, got, t_index, j_index = T._wave_streams({arch!r}, {dtype!r},
                                              {overrides!r})
print(json.dumps({{"want": want, "got": got, "t_index": t_index,
                   "j_index": j_index}}))
"""


@pytest.mark.parametrize("arch,dtype,overrides", [
    ("qwen2.5-3b", "bfloat16", None),                   # a bf16 cache
    ("moonshot-v1-16b-a3b", "float32", _INT8)],         # an int8 cache
    ids=["bf16_cache", "int8_cache"])
def test_waves_past_max_len_match_jax_scan_engine(arch, dtype, overrides):
    if dtype == "bfloat16":
        # the bf16 reference rounds every op only with excess precision off
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        out = subprocess.run(
            [sys.executable, "-c", _WAVES_SCRIPT.format(
                tests=str(ROOT / "tests"), arch=arch, dtype=dtype,
                overrides=overrides)],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        want, got = res["want"], res["got"]
        t_index, j_index = res["t_index"], res["j_index"]
    else:
        want, got, t_index, j_index = _wave_streams(arch, dtype, overrides)
    assert t_index == j_index > WAVE_LEN
    assert got == want
    assert all(len(s) >= 1 for wave in got for s in wave.values())


def test_requests_are_the_jax_launchers():
    """The launchers draw the same prompts: lengths 4-11, tokens below
    the vocab, from ``np.random.default_rng(0)``."""
    cfg = TSERVE.make_config("qwen2.5-3b")
    reqs = TSERVE.make_requests(cfg, 6, 16)
    rng = np.random.default_rng(0)
    for r in reqs:
        want = rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
        assert np.array_equal(r.prompt, want.astype(np.int32))
        assert 4 <= len(r.prompt) <= 11 and r.max_new_tokens == 16


@pytest.mark.parametrize("kw", [dict(prefill="bucketed"),
                                dict(detok_thread=True),
                                dict(pack_prefill=True)])
def test_engine_outside_the_slice_raises(kw):
    cfg = TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref")
    model, params = TSERVE.build_lm(cfg, TSERVE.resolve_device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(model, params, max_batch=1, max_len=8, **kw)
    with pytest.raises(TypeError):
        TEngine(model, params, max_batch=1, max_len=8, no_such_knob=1)


def test_launcher_serves_smoke_on_cpu(capsys):
    out = TSERVE.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--max-batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "TF32" in lines[0] and "backend ref" in lines[0]
    summary = json.loads(lines[-1])
    assert summary == json.loads(json.dumps(out))
    assert summary["tokens"] == 3 * 4 and summary["device"] == "cpu"
    assert summary["launches"] == {k: 0 for k in (
        "fused_matmul_nladc", "prefill_attention", "nladc",
        "moe_fused_matmul", "flash_decode_int8")}
    assert summary["decode_steps"] > 0 and summary["tokens_per_s"] > 0


def test_launcher_overrides_config_fields():
    """``--override key=value`` as the JAX dryrun reads it: literals where
    they parse, strings otherwise."""
    assert TSERVE.parse_overrides(["n_layers=24", "kv_cache_dtype=int8",
                                   "rope_theta=1e4"]) == {
        "n_layers": 24, "kv_cache_dtype": "int8", "rope_theta": 1e4}
    out = TSERVE.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                       "--device", "cpu", "--override", "n_layers=1",
                       "--override", "kv_cache_dtype=int8",
                       "--requests", "2", "--max-new", "2"])
    assert out["n_layers"] == 1 and out["kv_cache_dtype"] == "int8"
    assert out["tokens"] == 4
    with pytest.raises(ValueError, match="key=value"):
        TSERVE.parse_overrides(["n_layers"])


def test_launcher_serves_every_analog_mode():
    """Infer mode serves on the preset's programmed ramps, train mode on
    the ideal ramps."""
    kw = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
          "--requests", "2", "--max-new", "4"]
    outs = {mode: TSERVE.main(kw + ["--analog-mode", mode,
                                    "--analog-device", "paper-infer"])
            for mode in ("exact", "infer", "train")}
    assert all(o["tokens"] == 8 for o in outs.values())
    cfg = TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref",
                             analog_mode="infer", analog_device="paper-infer")
    model, params = TSERVE.build_lm(cfg, TSERVE.resolve_device("cpu"))
    assert model.act.cfg.mode == "infer" and model.act.cfg.device.name \
        == "paper-infer"
    assert not torch.equal(model.act.adc.thresholds, TSERVE.build_lm(
        TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref"),
        TSERVE.resolve_device("cpu"))[0].act.adc.thresholds)


def test_launcher_refuses_unported_modes():
    """Expert parallelism and the engine's lifecycle (``device=``) stay
    unported, and each refusal names its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSERVE.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device",
                     "cpu", "--override", "moe_impl=ep_shardmap",
                     "--requests", "1", "--max-new", "1"])
    cfg = TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref",
                             analog_mode="infer", analog_device="paper-infer")
    model, params = TSERVE.build_lm(cfg, TSERVE.resolve_device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(model, params, max_batch=1, max_len=8, device="paper")


def test_launcher_reads_params_npz(tmp_path, capsys):
    cfg = JC.get_smoke("qwen2.5-3b")
    jp = jbuild(cfg.replace(analog=dataclasses.replace(
        cfg.analog, backend="ref"))).init(jax.random.PRNGKey(1))
    path = tmp_path / "lm.npz"
    convert.save_npz(path, jax.tree_util.tree_map(np.asarray, jp))
    out = TSERVE.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                       "--requests", "1", "--max-new", "2",
                       "--params", str(path)])
    assert out["tokens"] == 2
