"""``repro_torch.obs`` against the JAX package's ``repro.obs``.

The same call sequence, from the same seeded values, through both
packages' metrics registry, tracer, event bus, ``Obs`` bundle and replay
gives equal snapshots, Prometheus text, JSONL and rendered timelines;
the histogram merge is commutative and associative with an identity
(hypothesis) and the port's merge is the reference's.  The engine's
spans, trace events and metrics are the reference engine's on a seeded
run; two seeded runs write the same JSONL bytes.  ``ChipEnergyModel.price``
at qwen2.5-3b's and moonshot-v1-16b-a3b's published widths, from shapes
only (``jax.eval_shape`` against ``device="meta"`` tensors), is the
reference's to the bit: the port's per-layer list is priced as the
reference's stacked leaves.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.obs as JOBS
from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro.obs import replay as JREPLAY
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
import repro_torch.obs as TOBS
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.obs import replay as TREPLAY
from repro_torch.serve.engine import Request, ServingEngine

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

SIDES = {"jax": JOBS, "torch": TOBS}


def _drive(mod, seed=0):
    """One seeded call sequence through a package's obs layer."""
    rng = np.random.default_rng(seed)
    obs = mod.Obs(trace=True)
    chips = [obs.child(f"chip{i:02d}") for i in range(3)]
    for step in range(12):
        obs.set_step(step)
        for c in chips:
            c.counter("serve.tokens_total").inc(int(rng.integers(0, 5)))
            c.gauge("lifecycle.inl_lsb").set(float(rng.normal()))
            h = c.histogram("serve.ttft_steps")
            for v in rng.exponential(3.0, size=int(rng.integers(0, 4))):
                h.record(float(v))
            c.histogram("serve.itl_ms").record(float(rng.normal(5, 2)))
            with c.span("decode", active=int(rng.integers(1, 4))) as sp:
                sp.set(step_kind="decode")
            if rng.random() < 0.3:
                c.emit("probe", step=step, src="sched",
                       inl_lsb=round(float(rng.random()), 4))
            c.trace_event("first_token", uid=int(step),
                          ttft_steps=int(rng.integers(0, 3)))
        obs.emit("drain_start", step=step, src="fleet", chip="chip01",
                 handoff={})
    return obs


def test_metrics_trace_and_bus_are_the_references(tmp_path):
    out = {side: _drive(mod) for side, mod in SIDES.items()}
    j, t = out["jax"], out["torch"]
    assert t.snapshot() == j.snapshot()
    assert t.metrics.to_prometheus() == j.metrics.to_prometheus()
    assert t.metrics.dump_json() == j.metrics.dump_json()
    assert t.tracer.to_jsonl() == j.tracer.to_jsonl()
    assert t.bus.events == j.bus.events
    assert t.bus.view(src="sched", chip="chip02") == \
        j.bus.view(src="sched", chip="chip02")
    for name in ("serve.ttft_steps", "serve.itl_ms"):
        assert t.metrics.merged_histogram(name).summary() == \
            j.metrics.merged_histogram(name).summary()
    # a snapshot restores into the other package's registry
    back = TOBS.Obs()
    back.restore(json.loads(json.dumps(j.snapshot())))
    assert back.snapshot() == j.snapshot()
    # replay renders both packages' JSONL the same way
    path = str(tmp_path / "t.jsonl")
    t.tracer.write_jsonl(path)
    entries = TOBS.read_jsonl(path)
    assert entries == JOBS.read_jsonl(path)
    assert TREPLAY.render_timeline(entries) == \
        JREPLAY.render_timeline(entries)
    assert TREPLAY.latency_summary(entries) == \
        JREPLAY.latency_summary(entries)
    assert TREPLAY.chips_in(entries) == JREPLAY.chips_in(entries)


def test_replay_cli_prints_the_references_text(tmp_path, capsys):
    path = str(tmp_path / "t.jsonl")
    _drive(TOBS, seed=3).tracer.write_jsonl(path)
    texts = []
    for mod in (TREPLAY, JREPLAY):
        assert mod.main([path, "--last", "5"]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and "latency summary" in texts[0]


_VALS = st.lists(st.floats(min_value=-1e9, max_value=1e9, allow_nan=False),
                 max_size=30)


def _hist(mod, vs):
    h = mod.Histogram("t")
    for v in vs:
        h.record(v)
    return h


@given(_VALS, _VALS, _VALS)
@settings(max_examples=50, deadline=None)
def test_histogram_merge_property(xs, ys, zs):
    a, b, c = (_hist(TOBS, v) for v in (xs, ys, zs))
    assert a.merge(b) == b.merge(a)
    assert a.merge(b).merge(c) == a.merge(b.merge(c))
    assert a.merge(TOBS.Histogram("t")) == a
    ja, jb = _hist(JOBS, xs), _hist(JOBS, ys)
    assert a.merge(b).to_dict() == ja.merge(jb).to_dict()
    assert a.merge(b).summary() == ja.merge(jb).summary()


@functools.lru_cache(maxsize=None)
def _smoke():
    jcfg = JC.get_smoke("qwen2.5-3b").replace(
        dtype="float32", analog=JSpec(enabled=True, mode="infer",
                                      device="aged-1day", backend="ref"))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(
        "qwen2.5-3b", smoke=True, backend="ref", analog_mode="infer",
        analog_device="aged-1day").replace(dtype="float32")
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _serve(side, **kw):
    jm, jp, tm, tp = _smoke()
    E, R, m, p = (JEngine, JRequest, jm, jp) if side == "jax" \
        else (ServingEngine, Request, tm, tp)
    obs = SIDES[side].Obs(trace=True)
    eng = E(m, p, max_batch=2, max_len=48, obs=obs, **kw)
    rng = np.random.default_rng(5)
    for uid in range(4):
        eng.submit(R(uid=uid, prompt=rng.integers(
            0, 256, int(rng.integers(2, 9))).astype(np.int32),
            max_new_tokens=3))
    stats = eng.run_offline()
    return eng, stats


@pytest.mark.parametrize("kw", [{}, dict(prefill="bucketed",
                                         pack_prefill=True)],
                         ids=["scan", "packed"])
def test_engine_trace_and_metrics_are_the_references(kw):
    """Spans (admit, prefill, decode), events (submit, admit,
    first_token, finish), counters, the step-clock histograms, the
    energy counters and ``run_offline``'s step-clock and energy reports
    are the reference engine's; two seeded runs write the same bytes."""
    (j, js), (t, ts) = _serve("jax", **kw), _serve("torch", **kw)
    assert TOBS.strip_wall(t.obs.tracer.entries) == \
        JOBS.strip_wall(j.obs.tracer.entries)
    assert t.obs.tracer.entries and not any(
        "wall_s" in e for e in t.obs.tracer.entries)

    def no_ms(snap):
        return [m for m in snap["metrics"] if not m["name"].endswith("_ms")]

    assert no_ms(t.obs.metrics.snapshot()) == no_ms(j.obs.metrics.snapshot())
    for key in ("tokens", "ttft_steps", "itl_steps", "energy"):
        assert ts[key] == js[key], key
    again, _ = _serve("torch", **kw)
    assert again.obs.tracer.to_jsonl() == t.obs.tracer.to_jsonl()


def _meta_params(arch):
    """The port's params of ``arch`` at its published widths as meta
    tensors (initialized under a fake-tensor mode: no storage)."""
    m = tbuild(TSERVE.make_config(arch, backend="ref"), device="cpu")
    with FakeTensorMode():
        gen = torch.Generator()
        gen.manual_seed(0)
        fake = m.init(gen)

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    return meta(fake)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b",
                                  "mamba2-370m", "recurrentgemma-9b"])
def test_energy_price_at_published_widths(arch):
    jm = jbuild(JC.get(arch))
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tparams = _meta_params(arch)
    assert tparams["embed"]["table"].device.type == "meta"
    for kw in (dict(bits=5, bank_cols=0, redundancy=1),
               dict(bits=4, bank_cols=512, redundancy=3)):
        a = TOBS.ChipEnergyModel.price(tparams, **kw).to_dict()
        b = JOBS.ChipEnergyModel.price(jshapes, **kw).to_dict()
        assert repr(a) == repr(b)
        assert a["n_macros"] > 0


@pytest.mark.parametrize("arch,n_layers", [("recurrentgemma-9b", 5),
                                           ("mamba2-370m", 2)])
def test_macro_shapes_are_the_references(arch, n_layers):
    """Key for key, the reference's crossbar macros at SMOKE widths: the
    stacked ``layers`` or hybrid ``groups`` one macro of count n a leaf,
    the hybrid's 2-block ``tail`` (at 5 layers) priced block by block,
    its 1-D ``lam`` in no macro."""
    jm = jbuild(JC.get_smoke(arch).replace(n_layers=n_layers))
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = tbuild(TSERVE.make_config(arch, smoke=True, backend="ref",
                                   overrides={"n_layers": n_layers}),
                device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    got = TOBS.energy._macro_shapes(tm.init(gen))
    assert got == JOBS.energy._macro_shapes(jshapes)
    tail = [k for k in got if k.startswith("['tail']")]
    assert bool(tail) == (arch == "recurrentgemma-9b")
    assert all(k.startswith(("['tail'][0]", "['tail'][1]")) for k in tail)
    assert not any("['lam']" in k for k in got)
