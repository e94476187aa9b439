"""The scan-prefill serving engine: repro_torch's ``ServingEngine``
against the JAX package's ``ServingEngine(prefill="scan")`` at the
qwen2.5-3b SMOKE widths in float32, exact mode, ``ref`` backend, with the
same weights (``lm_params_from_jax``) and the same 6 requests (the serve
launchers' ``np.random.default_rng(0)`` prompts), max_batch 4, max_new 8:
the token streams must be identical.  Then the launcher on the CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import ServingEngine as TEngine

N_REQ, MAX_BATCH, MAX_NEW, MAX_LEN = 6, 4, 8, 64


def _streams(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    return {r.uid: list(r.generated) for r in reqs}


def test_token_streams_match_jax_scan_engine():
    jcfg = JC.get_smoke("qwen2.5-3b").replace(
        dtype="float32", analog=JSpec(enabled=True, adc_bits=5,
                                      activation="silu", backend="ref"))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref")
    tcfg = tcfg.replace(dtype="float32")
    tm = tbuild(tcfg)
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))

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
    assert summary["launches"] == {"fused_matmul_nladc": 0,
                                   "prefill_attention": 0}
    assert summary["decode_steps"] > 0 and summary["tokens_per_s"] > 0


def test_launcher_refuses_unported_modes():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSERVE.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                     "--analog-mode", "infer"])
    with pytest.raises(NotImplementedError):
        TSERVE.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                     "--analog-mode", "train"])


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
