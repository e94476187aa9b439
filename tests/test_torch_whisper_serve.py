"""whisper-base served and trained through the port's entry points:
repro_torch's ``ServingEngine`` against the JAX package's, on SMOKE in
float32, exact mode, ``ref`` backend, the same weights
(``convert.encdec_params_from_jax``), ``max_batch`` 2, ``max_len`` 48 and
``tests/test_torch_serve_bucketed.py``'s prompts.

* The engine serves the decoder on text with cross K/V of zeros, as the
  reference's engine does (it never calls ``start_decode``): the token
  streams of the scan, bucketed, packed and chunked prefills equal the
  JAX scan engine's; the unpacked caches are bitwise the port's scan
  path's, the packed ones within atol 1e-5; the cross K/V stay zero.
* ``decode_state_batch_axes`` is the reference's less its stacked layer
  axis, and ``prefill_cache`` leaves the cross K/V untouched.
* The energy model prices the reference's stacked ``enc_layers`` and
  ``dec_layers``: the reference's variants, to the bit.
* The deployment (aging, ``recal=``, the checkpoint, the fleet) is held
  to the reference in ``tests/test_torch_whisper_deploy.py`` and
  ``tests/test_torch_whisper_fleet.py``.
* CPU rehearsals: ``python -m repro_torch.launch.serve --arch
  whisper-base --smoke --device cpu`` (scan and packed) and ``launch.train
  --arch whisper-base --smoke --device cpu`` in train mode.
"""

import functools

import numpy as np
import pytest
import torch

from repro.nn import model as JM
from repro.obs.energy import ChipEnergyModel as JEnergy
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TTRAIN
from repro_torch.nn import model as TM
from repro_torch.obs.energy import ChipEnergyModel
from repro_torch.serve.engine import Request, ServingEngine
from test_torch_serve_bucketed import MAX_BATCH, MAX_LEN, MAX_NEW, PROMPTS
from test_torch_whisper import models

PACKED_ATOL = 1e-5
MODES = {
    "bucketed": dict(prefill="bucketed"),
    "packed": dict(prefill="bucketed", pack_prefill=True),
    "chunked": dict(prefill="bucketed", pack_prefill=True,
                    prefill_buckets=(4, 8)),
}


def _run(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    n = eng.run_to_completion()
    return n, [list(r.generated) for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _jax_scan():
    jm, jp, _, _ = models("exact")
    n, streams, eng = _run(JEngine, JRequest, jm, jp, prefill="scan")
    assert not np.asarray(eng.state["cross_k"]).any()
    return n, streams


@functools.lru_cache(maxsize=None)
def _port_scan():
    _, _, tm, tp = models("exact")
    return _run(ServingEngine, Request, tm, tp)


def _leaves(eng):
    return [t for _, blk in eng.model.blocks(eng.state)
            for _, t in sorted(blk.items())]


@pytest.mark.parametrize("mode", ["scan"] + sorted(MODES))
def test_prefill_modes_match_jax_scan_engine(mode):
    n0, s0, e0 = _port_scan()
    assert (n0, s0) == _jax_scan()
    if mode == "scan":
        eng = e0
    else:
        _, _, tm, tp = models("exact")
        n1, s1, eng = _run(ServingEngine, Request, tm, tp, **MODES[mode])
        assert (n1, s1) == (n0, s0), f"stream mismatch ({mode})"
        assert eng.state["index"] == e0.state["index"]
        diff = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(_leaves(e0), _leaves(eng)))
        if MODES[mode].get("pack_prefill"):
            assert diff <= PACKED_ATOL, f"packed leaves {diff} from scan"
        else:
            assert diff == 0.0, f"decode-state leaf mismatch ({mode})"
        if mode == "chunked":
            assert 8 in eng.buckets_called \
                and eng.prefill_steps == sum(eng.buckets_called)
    assert all(not t.any() for c in eng.state["cross"] for t in c.values())


def test_batch_axes_and_prefill_cache_keep_the_cross_kv():
    jm, _, tm, tp = models("exact")
    axes, want = TM.decode_state_batch_axes(tm), \
        JM.decode_state_batch_axes(jm)
    assert axes["index"] == want["index"] == -1
    assert all({n: ax + 1 for n, ax in layer.items()} == want["self"]
               for layer in axes["self"])
    assert all(layer == {"k": 0, "v": 0} for layer in axes["cross"])
    assert want["cross_k"] == want["cross_v"] == 1
    state = tm.init_decode_state(2, 16)
    for c in state["cross"]:
        c["k"].fill_(0.5)
        c["v"].fill_(-0.5)
    kept = [{n: t.clone() for n, t in c.items()} for c in state["cross"]]
    toks = torch.tensor([[3, 9, 4, 1], [8, 2, 0, 0]])
    state = tm.prefill_cache(tp, state, toks, np.asarray([4, 2]))
    assert state["index"] == 4
    assert all(torch.equal(c[n], k[n]) for c, k in zip(state["cross"], kept)
               for n in "kv")
    solo = tm.init_decode_state(1, 16)
    solo["cross"] = [{n: t[1:].clone() for n, t in c.items()}
                     for c in kept]
    for t in range(2):
        _, solo = tm.decode_step(tp, solo, toks[1:, t:t + 1])
    for packed, alone in zip(state["self"], solo["self"]):
        for name, t in packed.items():
            assert torch.allclose(t[1, :2], alone[name][0, :2], rtol=0,
                                  atol=PACKED_ATOL)
            assert not t[1, 2:].any()


def test_energy_model_is_the_references():
    _, jp, _, tp = models("exact")
    want = JEnergy.price(jp, bits=5, bank_cols=16)
    got = ChipEnergyModel.price(tp, bits=5, bank_cols=16)
    # the 16 weight matrices of the two stacks, and as the reference
    # reads them, pos_dec and the 9 stacked Q/K/V biases (n_layers, width)
    assert got.n_macros == want.n_macros == 16 + 1 + 9
    assert got.variants == want.variants


@pytest.mark.parametrize("packed", [False, True])
def test_serve_launcher_on_the_cpu(packed):
    argv = ["--arch", "whisper-base", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4"]
    if packed:
        argv += ["--prefill-buckets", "auto", "--pack-prefill"]
    out = TSERVE.main(argv)
    assert out["arch"] == "whisper-base-smoke" and out["tokens"] == 12
    assert out["prefill"] == ("bucketed" if packed else "scan")
    assert out["energy"]["nladc"]["tokens_per_joule"] > 0


def test_train_launcher_on_the_cpu():
    out = TTRAIN.main(["--arch", "whisper-base", "--smoke", "--device",
                       "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--analog-mode", "train", "--analog-device",
                       "paper"])
    assert out["analog_mode"] == "train" and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert out["aux_losses"] == [0.0, 0.0]


def test_train_launcher_feeds_the_frames():
    """The trainer's batch carries the stub frontend's frames (seed 7),
    the same every step."""
    cfg = TSERVE.make_config("whisper-base", smoke=True)
    _, trainer, _ = TTRAIN.build_trainer(cfg, torch.device("cpu"), steps=1,
                                         batch=2, seq=8, log=None)
    a, b = (trainer.put_batch(trainer.pipeline.batch_at(i))
            for i in (0, 1))
    assert tuple(a["frames"].shape) == (2, cfg.enc_len, cfg.d_model)
    assert torch.equal(a["frames"], b["frames"])
    gen = torch.Generator()
    gen.manual_seed(7)
    assert torch.equal(a["frames"], torch.randn(a["frames"].shape,
                                                generator=gen))
