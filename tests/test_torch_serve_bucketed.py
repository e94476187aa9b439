"""The bucketed, packed and chunked prefill and the detokenize thread:
repro_torch's ``ServingEngine`` against the JAX package's scan engine.

qwen2.5-3b SMOKE in float32 and moonshot-v1-16b-a3b SMOKE with an int8
KV cache (deepseek-moe-16b SMOKE on the scan and packed paths), exact
mode, ``ref`` backend, the same weights
(``lm_params_from_jax``), ``max_batch`` 2, ``max_len`` 48 and the
reference's own throughput-test prompts (5, 13, 1 and 22 tokens: a
prompt with no prefill, and one longer than the chunked case's largest
bucket).  On every path the token streams equal the JAX scan engine's.
The decode-state leaves: the unpacked bucketed path is bitwise the port's
scan path; the packed path runs the gate and the attention on P rows at
once, so its caches agree with the scan path's within atol 1e-5 (the
reference's own packed path is 1.67e-6 from its scan path at this
setup), and bitwise where the port turns out bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn import model as JM
from repro.nn.model import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.nn import model as TM
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import Request, ServingEngine

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

PROMPTS = [np.arange(1, 6, dtype=np.int32),        # short
           np.arange(2, 15, dtype=np.int32),       # medium
           np.asarray([7], np.int32),              # degenerate (no prefill)
           np.arange(3, 25, dtype=np.int32)]       # long
MAX_BATCH, MAX_LEN, MAX_NEW = 2, 48, 6
PACKED_ATOL = 1e-5
# the int8 cache's quantization absorbs the packed rows' rounding here
BITWISE_PACKED = {"moe_int8"}
_INT8 = {"kv_cache_dtype": "int8"}
ARCHS = {"qwen": ("qwen2.5-3b", None), "moe_int8": ("moonshot-v1-16b-a3b",
                                                    _INT8)}
# served on the scan and packed paths only (the suite's time)
DEEPSEEK = {"deepseek": ("deepseek-moe-16b", None)}
_MODELS = {}


def _models(key):
    """(jax model, jax params, port model, port params), built once."""
    if key not in _MODELS:
        arch, overrides = {**ARCHS, **DEEPSEEK}[key]
        jcfg = JC.get_smoke(arch).replace(
            dtype="float32", analog=JSpec(enabled=True, adc_bits=5,
                                          activation="silu", backend="ref"),
            **(overrides or {}))
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tcfg = TSERVE.make_config(arch, smoke=True, backend="ref",
                                  overrides=overrides).replace(
                                      dtype="float32")
        tm = tbuild(tcfg, device="cpu")
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp))
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _run(engine_cls, request_cls, model, params, prompts=PROMPTS, *,
         max_new=MAX_NEW, eos_id=-1, **kw):
    eng = engine_cls(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=max_new,
                        eos_id=eos_id) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    n = eng.run_to_completion()
    return n, [list(r.generated) for r in reqs], eng


_JAX_SCAN = {}


def _jax_scan(key):
    if key not in _JAX_SCAN:
        jm, jp, _, _ = _models(key)
        n, streams, _ = _run(JEngine, JRequest, jm, jp, prefill="scan")
        _JAX_SCAN[key] = (n, streams)
    return _JAX_SCAN[key]


_PORT_SCAN = {}


def _port_scan(key):
    """The port's scan engine run once per config: every prefill mode is
    held to it (its engine's decode state is only read)."""
    if key not in _PORT_SCAN:
        _, _, tm, tp = _models(key)
        _PORT_SCAN[key] = _run(ServingEngine, Request, tm, tp)
    return _PORT_SCAN[key]


def _cache_leaves(eng):
    return [t for layer in eng.state["layers"] for _, t in
            sorted(layer.items())]


def _max_diff(e0, e1):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(_cache_leaves(e0), _cache_leaves(e1)))


MODES = {
    "bucketed": dict(prefill="bucketed"),
    "packed": dict(prefill="bucketed", pack_prefill=True),
    "chunked": dict(prefill="bucketed", pack_prefill=True,
                    prefill_buckets=(4, 8)),
    "chunked_unpacked": dict(prefill="bucketed", prefill_buckets=(4, 8)),
    "detok": dict(detok_thread=True),
    "packed_detok": dict(prefill="bucketed", pack_prefill=True,
                         detok_thread=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("key", sorted(ARCHS))
def test_prefill_modes_match_jax_scan_engine(key, mode):
    _, _, tm, tp = _models(key)
    want = _jax_scan(key)
    n0, s0, e0 = _port_scan(key)
    assert (n0, s0) == want
    n1, s1, e1 = _run(ServingEngine, Request, tm, tp, **MODES[mode])
    assert (n1, s1) == want, f"stream mismatch ({mode})"
    assert e1.state["index"] == e0.state["index"]
    diff = _max_diff(e0, e1)
    if MODES[mode].get("pack_prefill") and key not in BITWISE_PACKED:
        assert diff <= PACKED_ATOL, f"packed leaves {diff} from scan"
    else:
        assert diff == 0.0, f"decode-state leaf mismatch vs scan ({mode})"
    if mode.startswith("chunked"):
        # the 21-token prefill runs as 8 + 8 + 8: chunks of the largest
        # bucket, the last one padded
        assert 8 in e1.buckets_called and \
            e1.prefill_steps == sum(e1.buckets_called)


@pytest.mark.parametrize("mode", ["scan", "packed"])
def test_deepseek_matches_jax_scan_engine(mode):
    """deepseek-moe-16b (its softmax router and shared expert): the scan
    and packed streams are the JAX scan engine's, the packed caches within
    PACKED_ATOL of the port's scan."""
    n0, s0, e0 = _port_scan("deepseek")
    assert (n0, s0) == _jax_scan("deepseek")
    if mode == "scan":
        return
    _, _, tm, tp = _models("deepseek")
    n1, s1, e1 = _run(ServingEngine, Request, tm, tp, **MODES[mode])
    assert (n1, s1) == (n0, s0), "packed streams differ from the scan's"
    assert e1.state["index"] == e0.state["index"]
    assert _max_diff(e0, e1) <= PACKED_ATOL


@pytest.mark.parametrize("max_len", [2, 9, 16, 48, 128, 200])
def test_default_buckets_are_the_references(max_len):
    assert ServingEngine._default_buckets(max_len) == \
        JEngine._default_buckets(max_len)


def test_bucket_for_is_the_references():
    _, _, tm, tp = _models("qwen")
    jm, jp, _, _ = _models("qwen")
    for buckets in [None, (4, 8), (3, 10, 20)]:
        te = ServingEngine(tm, tp, max_batch=2, max_len=48,
                           prefill="bucketed", prefill_buckets=buckets)
        je = JEngine(jm, jp, max_batch=2, max_len=48, prefill="bucketed",
                     prefill_buckets=buckets)
        assert te.prefill_buckets == je.prefill_buckets
        assert [te._bucket_for(n) for n in range(1, 60)] == \
            [je._bucket_for(n) for n in range(1, 60)]


@pytest.mark.parametrize("kw,match", [
    (dict(pack_prefill=True), "require prefill='bucketed'"),
    (dict(prefill_buckets=(8,)), "require prefill='bucketed'"),
    (dict(prefill="bucketed", prefill_buckets=(8, 8)),
     "strictly increasing"),
    (dict(prefill="bucketed", prefill_buckets=(16, 8)),
     "strictly increasing"),
    (dict(prefill="bucketed", prefill_buckets=(0, 8)),
     "strictly increasing"),
    (dict(prefill="eager"), "prefill must be")],
    ids=["pack_no_buckets", "buckets_no_bucketed", "repeat", "descending",
         "zero", "unknown_mode"])
def test_bucket_validation(kw, match):
    jm, jp, tm, tp = _models("qwen")
    with pytest.raises(ValueError, match=match) as te:
        ServingEngine(tm, tp, max_batch=2, max_len=48, **kw)
    with pytest.raises(ValueError) as je:
        JEngine(jm, jp, max_batch=2, max_len=48, **kw)
    assert str(te.value) == str(je.value)


def test_detok_eos_truncation():
    """EOS lags one step on the worker, but the stream is truncated as
    the synchronous path truncates it (and as the JAX engine does)."""
    jm, jp, tm, tp = _models("qwen")
    prompts = PROMPTS[:2]                      # one wave, no slot reuse
    _, s0, _ = _run(ServingEngine, Request, tm, tp, prompts, max_new=8)
    eos = s0[0][2]                             # a token that DOES occur
    _, sync, _ = _run(ServingEngine, Request, tm, tp, prompts, max_new=8,
                      eos_id=eos)
    _, detok, _ = _run(ServingEngine, Request, tm, tp, prompts, max_new=8,
                       eos_id=eos, detok_thread=True)
    _, packed, _ = _run(ServingEngine, Request, tm, tp, prompts, max_new=8,
                        eos_id=eos, detok_thread=True, prefill="bucketed",
                        pack_prefill=True)
    _, want, _ = _run(JEngine, JRequest, jm, jp, prompts, max_new=8,
                      eos_id=eos)
    assert sync == detok == packed == want
    assert sync[0][-1] == eos and len(sync[0]) <= len(s0[0])


def test_detok_step_lags_and_flush_lands_everything():
    _, _, tm, tp = _models("qwen")
    eng = ServingEngine(tm, tp, max_batch=2, max_len=48, detok_thread=True)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(PROMPTS[:2])]
    for r in reqs:
        eng.submit(r)
    landed = sum(len(eng.step()) for _ in range(4))
    landed += sum(len(b) for b in eng.detok_flush())
    assert landed == 8 and all(len(r.generated) == 4 for r in reqs)
    assert all(eng.slot_free)
    assert list(eng.slot_last) == [r.generated[-1] for r in reqs]


def test_warmup_runs_every_bucket_and_advances_nothing():
    _, _, tm, tp = _models("qwen")
    eng = ServingEngine(tm, tp, max_batch=2, max_len=48, prefill="bucketed",
                        pack_prefill=True)
    before = [t.clone() for t in _cache_leaves(eng)]
    assert eng.prefill_buckets == (8, 16, 32, 47)
    assert eng.warmup() == {"prefill_buckets": [8, 16, 32, 47],
                            "decode": True}
    assert eng.state["index"] == 0 and eng.prefill_steps == 0 \
        and eng.decode_steps == 0 and eng.buckets_called == []
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 _cache_leaves(eng)))


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_prefill_cache_is_decode_steps_row_by_row(key):
    """One packed, masked call fills each row's cache as that row's own
    decode steps do, and leaves the slots past a row's length zero.  The
    caches' batch axis is the reference's less its stacked layer axis:
    0 in every layer, the layout ``prefill_cache`` writes."""
    jm, _, tm, tp = _models(key)
    lens = [5, 2, 0]
    toks = torch.tensor([[3, 9, 4, 1, 7, 0], [8, 2, 0, 0, 0, 0],
                         [0] * 6])
    axes, want = TM.decode_state_batch_axes(tm), \
        JM.decode_state_batch_axes(jm)
    assert axes["index"] == want["index"] == -1
    assert len(axes["layers"]) == tm.cfg.n_layers and all(
        {name: ax + 1 for name, ax in layer.items()} == want["layers"]
        for layer in axes["layers"])
    assert all(ax == 0 for layer in axes["layers"] for ax in layer.values())
    state = tm.prefill_cache(tp, tm.init_decode_state(3, 16), toks,
                             np.asarray(lens))
    assert state["index"] == 6
    for row, n in enumerate(lens):
        solo = tm.init_decode_state(1, 16)
        for t in range(n):
            _, solo = tm.decode_step(tp, solo, toks[row:row + 1, t:t + 1])
        for packed, alone in zip(state["layers"], solo["layers"]):
            for name, t in packed.items():
                assert torch.allclose(t[row, :n].double(),
                                      alone[name][0, :n].double(),
                                      rtol=0, atol=PACKED_ATOL)
                assert not t[row, n:].any()
