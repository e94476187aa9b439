"""Training the recurrent LM families, the trainer and the launcher:
repro_torch's ``Trainer`` over ``make_train_step`` for mamba2-370m (2 SSD
layers) and recurrentgemma-9b (``n_layers=5``: one (rec, rec, attn) group
and a (rec, rec) tail) against the JAX package's ``Trainer``, at the SMOKE
widths, float32, train mode on ``paper``, flat thresholds and 16-column
banks, the ramp draws replayed through the reference's key tree
(``tests/test_torch_lm_recurrent_train.py::draws``).

* Three ``Trainer`` steps against the reference's: loss, token count and
  gradient norm within rtol 1e-5, and the trainers' ``Obs`` metrics and
  trace, as ``tests/test_torch_lm_train.py`` holds qwen's.
* ``python -m repro_torch.launch.train --smoke --device cpu`` for both
  archs (the ``ref`` backend, no kernel launched), and ``--ckpt-dir``: a
  run resumed at step 2 is bitwise the uninterrupted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as JS
from repro.obs import Obs as JObs
from repro.train import loop as JLOOP
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTRAIN
from repro_torch.obs import Obs as TObs
from repro_torch.train import loop as TLOOP
from repro_torch.train import optim as TO
from test_torch_lm_recurrent_train import (ARCHS, B, BANK_COLS, OVERRIDES, S,
                                           _models, draws)
from test_torch_trainer import hold_obs

import _torch_threads  # noqa: E402,F401  (one intra-op thread)


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_trainer_steps_match_the_reference(arch, banked):
    jm, jp, tm, tp = _models(arch, BANK_COLS if banked else 0)
    seq, bsz, steps = S, B, 3
    jopt = JS.make_optimizer(jm.cfg, total_steps=steps)
    jobs, tobs = JObs(trace=True), TObs(trace=True)
    jtr = JLOOP.Trainer(jm, jopt, JS.make_train_step(jm, jopt),
                        JSyntheticLM(jm.cfg.vocab, seq, bsz), log_every=1,
                        obs=jobs)
    jp = jax.tree_util.tree_map(jnp.copy, jp)       # the step donates it
    jtr.fit(JLOOP.TrainState(jp, jopt.init(jp)), steps)

    topt = TS.make_optimizer(tm.cfg, total_steps=steps)
    step = TS.make_train_step(tm, topt, noise_for=lambda seed: ReplayNoise(
        draws(jm, jax.random.PRNGKey(seed))))
    ttr = TLOOP.Trainer(tm, topt, step, SyntheticLM(tm.cfg.vocab, seq, bsz),
                        put_batch=lambda b: TLOOP.to_device_batch(
                            b, torch.device("cpu")), log_every=1, obs=tobs,
                        log=None)
    state = ttr.fit(TLOOP.TrainState(tp, topt.init(tp)), steps)
    assert [h["step"] for h in ttr.history] == [1, 2, 3]
    assert int(state.opt_state.count) == 3
    for got, want in zip(ttr.history, jtr.history):
        for k in ("loss", "tokens", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    hold_obs(tobs, jobs, steps)


def _argv(arch, steps, extra=()):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps",
            str(steps), "--batch", "2", "--seq", "16", "--analog-mode",
            "train", "--analog-device", "paper", *extra]
    if arch == "recurrentgemma-9b":
        argv += ["--override", "n_layers=5"]
    return argv


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_and_resumes_on_cpu(arch, tmp_path, capsys):
    """``launch.train`` trains both families (ref backend, no kernel
    launched on the CPU), and ``--ckpt-dir`` resumes a run stopped at step
    2: step 3's loss and the checkpointed params and moments are bitwise
    the uninterrupted run's."""
    full = TTRAIN.main(_argv(arch, 3, ["--ckpt-dir", str(tmp_path / "a")]))
    lines = capsys.readouterr().out.strip().splitlines()
    assert "backend ref" in lines[0] and "analog mode train" in lines[0]
    assert full["n_layers"] == (5 if arch == "recurrentgemma-9b" else 2)
    assert full["steps"] == 3 and all(np.isfinite(full["losses"]
                                                  + full["grad_norms"]))
    assert full["launches"] == [{k: 0 for k in TTRAIN.KERNELS}] * 3

    ck = str(tmp_path / "b")
    _, part, state = _trainer(arch, ck)          # a 3-step run, stopped
    part.fit(state, 2)
    assert [h["loss"] for h in part.history] == full["losses"][:2]
    res = TTRAIN.main(_argv(arch, 3, ["--ckpt-dir", ck]))
    assert "resumed from step 2" in capsys.readouterr().out
    assert res["losses"] == full["losses"][2:]
    leaves = [_saved_leaves(arch, d) for d in (str(tmp_path / "a"), ck)]
    assert len(leaves[0]) == len(leaves[1]) > 0
    assert all(torch.equal(x, y) for x, y in zip(*leaves))


def _trainer(arch, ckpt_dir=None):
    """``launch.train``'s model, trainer and seeded state for ``_argv``'s
    3-step run."""
    cfg = TTRAIN.make_config(arch, smoke=True, backend="ref",
                             analog_mode="train", analog_device="paper",
                             overrides=dict(OVERRIDES[arch]))
    return TTRAIN.build_trainer(cfg, torch.device("cpu"), steps=3, batch=2,
                                seq=16, log=None, ckpt_dir=ckpt_dir)


def _saved_leaves(arch, root):
    """The params and Adam moments of ``root``'s step-3 checkpoint."""
    _, _, state = _trainer(arch)
    tree, step, _ = TCK.load_checkpoint(root, {"params": state.params,
                                               "opt": state.opt_state})
    assert step == 3
    opt = tree["opt"]
    return TO.tree_leaves(tree["params"]) + TO.tree_leaves(opt.mu) \
        + TO.tree_leaves(opt.nu)
