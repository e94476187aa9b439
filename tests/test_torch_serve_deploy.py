"""A deployment: aged weights in infer mode, and the engine's checkpoint.

repro_torch's ``ServingEngine(device=)`` against the JAX package's at
SMOKE sizes, float32, ``ref`` backend, the same weights
(``lm_params_from_jax``): under ``aged-1day`` the port's served params
are bitwise the reference engine's (the port's per-layer list aged with
the stacked leaves' draws), and the token streams equal the JAX engine's
on the same prefill path, and its scan path's wherever the reference's
own do (not the MoE's packed prefill, where expert capacity binds).
Then ``save``/``restore`` mid-stream into the scan path and into the
packed path with the detokenize thread: the streams and the decode caches
bitwise the uninterrupted run's; the served ramps and banks and the
metadata the reference's; the restore errors; the launcher's
``--ckpt-dir`` and ``--resume``.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.core.device import get_device as jget_device
from repro.nn.model import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.core.device import get_device as tget_device
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train.optim import tree_leaves

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

PRESET = "aged-1day"
_INT8 = {"kv_cache_dtype": "int8"}
ARCHS = {"qwen": ("qwen2.5-3b", None),
         "moe_int8": ("moonshot-v1-16b-a3b", _INT8)}
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(2, 15, dtype=np.int32),
           np.asarray([7], np.int32), np.arange(3, 25, dtype=np.int32),
           np.arange(5, 9, dtype=np.int32), np.arange(11, 20, dtype=np.int32)]
MAX_BATCH, MAX_LEN, MAX_NEW = 4, 48, 6
PACKED_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _models(key, mode="infer", bank_cols=0):
    """(jax model, jax params, port model, port params), built once a
    module (the engines leave them as they were)."""
    arch, overrides = ARCHS[key]
    jcfg = JC.get_smoke(arch).replace(
        dtype="float32", analog=JSpec(enabled=True, mode=mode, device=PRESET,
                                      backend="ref", bank_cols=bank_cols),
        **(overrides or {}))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(arch, smoke=True, backend="ref",
                              analog_mode=mode, analog_device=PRESET,
                              bank_cols=bank_cols,
                              overrides=overrides).replace(dtype="float32")
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _requests(cls, max_new=MAX_NEW):
    return [cls(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(PROMPTS)]


def _streams(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_aged_params_are_bitwise_the_reference_engines(key):
    jm, jp, tm, tp = _models(key)
    je = JEngine(jm, jp, max_batch=2, max_len=16,
                 device=jget_device(PRESET))
    te = ServingEngine(tm, tp, max_batch=2, max_len=16,
                       device=tget_device(PRESET))
    want = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params))
    got_l, want_l, pristine = (tree_leaves(te.params), tree_leaves(want),
                               tree_leaves(tp))
    assert len(got_l) == len(want_l) == len(pristine)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # every leaf but the top-level 1-D final norm scale is aged: the
    # reference's stacked per-layer vectors are (n_layers, N) matrices
    moved = [not torch.equal(a, p) for a, p in zip(got_l, pristine)]
    assert sum(moved) == len(moved) - 1
    assert not torch.equal(te.params["embed"]["table"],
                           tp["embed"]["table"])
    assert torch.equal(te.params["final_norm"]["scale"],
                       tp["final_norm"]["scale"])


MODES = {"scan": {}, "bucketed": dict(prefill="bucketed"),
         "packed_detok": dict(prefill="bucketed", pack_prefill=True,
                              detok_thread=True)}


@functools.lru_cache(maxsize=None)
def _jax_streams(key, mode):
    jm, jp, _, _ = _models(key)
    kw = {k: v for k, v in MODES[mode].items() if k != "detok_thread"}
    return _streams(JEngine(jm, jp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                            device=jget_device(PRESET), **kw),
                    _requests(JRequest))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("key", sorted(ARCHS))
def test_aged_streams_match_jax_engine(key, mode):
    """The port's streams are the JAX engine's on the same prefill path,
    and the JAX scan engine's on every path but one: the MoE's packed
    prefill.  There the reference's own streams leave its scan path's
    (its padding rows take expert capacity: SMOKE's 8 experts, top-2,
    hold 2 tokens an expert in a batch of 2 to 4, so a packed wave can
    drop a routed slot that a batch-1 scan step keeps), and the port
    follows the reference."""
    jm, jp, tm, tp = _models(key)
    want = {m: _jax_streams(key, m) for m in {"scan", mode}}
    got = _streams(ServingEngine(tm, tp, max_batch=MAX_BATCH,
                                 max_len=MAX_LEN,
                                 device=tget_device(PRESET), **MODES[mode]),
                   _requests(Request))
    assert got == want[mode]
    assert all(len(s) == MAX_NEW for s in got)
    if key == "moe_int8" and mode == "packed_detok":
        assert want[mode] != want["scan"]
    else:
        assert got == want["scan"]


def _cache(eng):
    return [t for layer in eng.state["layers"] for _, t in
            sorted(layer.items())]


def _clone(tree):
    """A restore template that may be overwritten: the cached models'
    params stay as they are."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


RESTORE = {"scan": {}, "packed_detok": dict(
    prefill="bucketed", pack_prefill=True, detok_thread=True)}


@pytest.mark.parametrize("queued", [False, True],
                         ids=["decoding", "with_queue"])
@pytest.mark.parametrize("into", sorted(RESTORE))
def test_midstream_restore_resumes_the_uninterrupted_run(tmp_path, into,
                                                         queued):
    """Saved mid-stream from a scan engine, restored into ``into``.  With
    every request admitted at the save (``decoding``) the rest is decode
    steps: streams and caches bitwise on both paths.  With requests
    still queued, the restored engine prefills them on its own path:
    streams equal, caches bitwise on the scan path and within the packed
    contract on the packed one."""
    _, _, tm, tp = _models("qwen")
    dev = tget_device(PRESET)

    def fresh():
        eng = ServingEngine(tm, tp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                            device=dev)
        reqs = _requests(Request)
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    ref_eng, ref_reqs = fresh()
    ref_eng.run_to_completion()
    want = [list(r.generated) for r in ref_reqs]

    eng, _ = fresh()
    steps = 3 if queued else MAX_NEW + 3
    for _ in range(steps):
        eng.step()
    assert bool(eng.queue) == queued and not all(eng.slot_free)
    root = str(tmp_path / "deploy")
    out = eng.save(root, step=steps)
    assert out.endswith(f"step_{steps:08d}")
    template = _clone(tp)
    res = ServingEngine.restore(tm, root, params_like=template,
                                **RESTORE[into])
    assert res.device.to_dict() == dev.to_dict()
    # the served params land in the template's own tensors: a restore
    # holds one copy of the weights
    assert all(a is b for a, b in zip(tree_leaves(res.params),
                                      tree_leaves(template)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(res.params),
                                                  tree_leaves(eng.params)))
    restored = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
    res.run_to_completion()
    for uid, r in restored.items():
        assert r.generated == want[uid], f"uid {uid} diverged"
    assert res.state["index"] == ref_eng.state["index"]
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in zip(_cache(ref_eng), _cache(res))]
    if queued and into == "packed_detok":
        assert max(diffs) <= PACKED_ATOL
    else:
        assert max(diffs) == 0.0


def test_checkpoint_holds_the_references_ramps_and_metadata(tmp_path):
    """The port's deployment checkpoint against the reference engine's at
    the same point of the same run, with banked thresholds: the same leaf
    paths (the layers stacked), and every leaf but the decode caches and
    the noise key bit for bit (the aged params, the served ramps and banks
    of every activation, the slot arrays); the metadata is the
    reference's, its ``obs`` block included (host-clock histograms
    aside)."""
    jm, jp, tm, tp = _models("qwen", bank_cols=16)
    je = JEngine(jm, jp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 device=jget_device(PRESET))
    te = ServingEngine(tm, tp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       device=tget_device(PRESET))
    for eng, reqs in ((je, _requests(JRequest)), (te, _requests(Request))):
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
    je.save(str(tmp_path / "j"), 3)
    te.save(str(tmp_path / "t"), 3)

    def manifest(sub):
        with open(tmp_path / sub / "step_00000003" / "manifest.json") as f:
            return json.load(f)

    mj, mt = manifest("j"), manifest("t")
    assert _no_wall(mt["metadata"]) == _no_wall(mj["metadata"])
    assert mt["metadata"]["banks"] == {"act": [160]}
    assert mt["paths"] == mj["paths"] and mt["dtypes"] == mj["dtypes"]
    shared = [p for p in mt["paths"] if not p.startswith(
        ("['state']", "['noise_key']"))]
    assert any(p.startswith("['params']['layers']") for p in shared)
    for p in shared:
        a = np.load(tmp_path / "t" / "step_00000003" /
                    f"leaf_{mt['paths'].index(p):05d}.npy")
        b = np.load(tmp_path / "j" / "step_00000003" /
                    f"leaf_{mj['paths'].index(p):05d}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), p


def _no_wall(meta):
    """Engine metadata without its host-clock (``*_ms``) histograms."""
    meta = json.loads(json.dumps(meta))
    if meta.get("obs"):
        snap = meta["obs"]["metrics"]
        snap["metrics"] = [m for m in snap["metrics"]
                           if not m["name"].endswith("_ms")]
    return meta


def _saved(tmp_path, bank_cols=0):
    _, _, tm, tp = _models("qwen", bank_cols=bank_cols)
    eng = ServingEngine(tm, tp, max_batch=2, max_len=16,
                        device=tget_device(PRESET))
    eng.submit(Request(uid=0, prompt=PROMPTS[0], max_new_tokens=4))
    eng.step()
    root = str(tmp_path / f"b{bank_cols}")
    eng.save(root, 1)
    return root


def _rewrite_meta(root, mutate):
    step = TCK.list_checkpoints(root)[-1]
    path = os.path.join(root, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    mutate(manifest["metadata"])
    with open(path, "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("case", ["not_engine", "newer_schema",
                                  "scheduler", "bank_saved_not_served",
                                  "bank_served_not_saved"])
def test_restore_errors(tmp_path, case):
    _, _, tm, tp = _models("qwen")
    if case == "not_engine":
        TCK.save_checkpoint(str(tmp_path), 0, {"params": np.zeros(3)},
                            metadata={"whatever": 1})
        with pytest.raises(ValueError,
                           match="not a ServingEngine deployment"):
            ServingEngine.restore(tm, str(tmp_path))
        return
    if case in ("newer_schema", "scheduler"):
        root = _saved(tmp_path)
        if case == "newer_schema":
            _rewrite_meta(root, lambda m: m.update(schema=99))
            with pytest.raises(ValueError,
                               match="schema 99.*upgrade repro"):
                ServingEngine.restore(tm, root, params_like=tp)
        else:
            # a scheduler block on a deployment saved without one: the
            # tree lacks the pristine params a scheduler re-ages from
            _rewrite_meta(root, lambda m: m.update(scheduler={"x": 1}))
            with pytest.raises(ValueError,
                               match="tree mismatch.*'pristine'"):
                ServingEngine.restore(tm, root, params_like=tp)
        return
    _, _, tm_b, tp_b = _models("qwen", bank_cols=16)
    if case == "bank_saved_not_served":
        with pytest.raises(ValueError, match="does not bank that width"):
            ServingEngine.restore(tm, _saved(tmp_path, 16), params_like=tp)
    else:
        with pytest.raises(ValueError, match="checkpoint has none there"):
            ServingEngine.restore(tm_b, _saved(tmp_path), params_like=tp_b)


def test_restore_migrates_schema1_checkpoint(tmp_path):
    """A schema-1 checkpoint (no schema, banks or lifecycle fields)
    restores and continues the same stream."""
    _, _, tm, tp = _models("qwen")
    dev = tget_device(PRESET)
    full = ServingEngine(tm, tp, max_batch=2, max_len=16, device=dev)
    req = Request(uid=0, prompt=PROMPTS[0], max_new_tokens=6)
    full.submit(req)
    full.run_to_completion()
    root = _saved(tmp_path)
    _rewrite_meta(root, lambda m: [m.pop(k) for k in
                                   ("schema", "banks", "lifecycle")])
    res = ServingEngine.restore(tm, root, params_like=_clone(tp))
    r = res.slot_req[0]
    res.run_to_completion()
    assert r.generated == req.generated[:4]


def test_launcher_serves_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    kw = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
          "--requests", "3", "--max-new", "4", "--analog-mode", "infer",
          "--analog-device", PRESET, "--ckpt-dir", ck]
    first = TSERVE.main(kw + ["--prefill-buckets", "auto",
                              "--pack-prefill", "--offline"])
    assert first["prefill"] == "bucketed" and first["pack_prefill"]
    assert first["prefill_buckets"] == [8, 16, 32, 64, 127]
    assert first["prefill_buckets_called"] == [16]
    assert first["aged"] == PRESET and first["tokens"] == 12
    assert first["ckpt"].endswith("step_00000012")
    second = TSERVE.main(kw + ["--resume", "--detok-thread"])
    out = capsys.readouterr().out
    assert "warmup: prefill buckets (8, 16, 32, 64, 127)" in out
    assert "resumed deployment from" in out
    assert second["ckpt"].endswith("step_00000024")
    assert second["tokens"] == 12 and second["detok_thread"]
    assert TCK.list_checkpoints(ck) == [12, 24]
