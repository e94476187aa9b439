"""Checkpoints: repro_torch's ``ckpt`` against the JAX package's.

The on-disk layout is the reference's, so a plain nested tree written by
one package (float32, bfloat16, int8, int32 and bool leaves, a list, a
named tuple) is read back bit for bit by the other, with the same leaf
paths and dtype names.  Then the manager's keep-k and ``.tmp`` GC, the
errors (a tree mismatch, a foreign manifest, a failed async save), and
the LM trainer's resume: bitwise the uninterrupted run, also through
``launch.train --ckpt-dir``.
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JCK
from repro.train.optim import OptState as JOptState
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.launch import train as TTRAIN
from repro_torch.launch.serve import make_config
from repro_torch.train import optim as TO


def _numpy_tree(seed: int):
    """A nested tree of numpy arrays (bfloat16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "w": rng.standard_normal((4, 6)).astype(np.float32),
        "b": {"bf16": bf.astype(ml_dtypes.bfloat16),
              "codes": rng.integers(-127, 128, (2, 7)).astype(np.int8),
              "flag": np.asarray([True, False, True])},
        "layers": [{"k": rng.standard_normal(3).astype(np.float32)},
                   {"k": rng.standard_normal(3).astype(np.float32)}],
        "opt": JOptState(np.asarray(3, np.int32),
                         {"m": np.float32(rng.standard_normal())},
                         {"m": np.float32(rng.standard_normal())}),
    }


def _to_torch(tree):
    """The same tree for the port: tensors, bfloat16 as torch's."""
    def one(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())

    return {"w": one(tree["w"]),
            "b": {k: one(v) for k, v in tree["b"].items()},
            "layers": [{"k": one(l["k"])} for l in tree["layers"]],
            "opt": TO.OptState(one(tree["opt"].count),
                               {"m": one(tree["opt"].mu["m"])},
                               {"m": one(tree["opt"].nu["m"])})}


def _bits(x) -> np.ndarray:
    """Raw bytes of a leaf of either package, and its dtype name."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = x.numpy()
        return a, a.dtype.name
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_is_read_bit_for_bit_by_the_other_package(tmp_path,
                                                             writer):
    jtree = _numpy_tree(0)
    ttree = _to_torch(jtree)
    root = str(tmp_path / "ck")
    meta = {"note": "x", "n": 3}
    if writer == "port":
        TCK.save_checkpoint(root, 7, ttree, metadata=meta)
        got, step, m = JCK.load_checkpoint(root, jtree)
        want = jtree
    else:
        JCK.save_checkpoint(root, 7, jtree, metadata=meta)
        got, step, m = TCK.load_checkpoint(root, ttree)
        want = ttree
        assert all(isinstance(x, torch.Tensor)
                   for x in jax.tree_util.tree_leaves(got))
    assert step == 7 and m == meta
    assert TCK.read_metadata(root) == JCK.read_metadata(root) == (7, meta)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert _manifest(root, 7)["paths"] == paths
    assert [p for p, _ in TCK._flatten(ttree)] == paths
    got_l, want_l = jax.tree_util.tree_leaves(got), \
        jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l) == len(paths)
    for a, b in zip(got_l, want_l):
        (ga, da), (wb, db) = _bits(a), _bits(b)
        assert da == db and ga.shape == wb.shape
        assert np.array_equal(ga, wb)
    assert type(got["opt"]).__name__ == "OptState"


def test_both_packages_write_the_same_files(tmp_path):
    jtree = _numpy_tree(1)
    TCK.save_checkpoint(str(tmp_path / "t"), 1, _to_torch(jtree))
    JCK.save_checkpoint(str(tmp_path / "j"), 1, jtree)
    mt, mj = _manifest(tmp_path / "t", 1), _manifest(tmp_path / "j", 1)
    assert mt == mj
    for i in range(mt["n_leaves"]):
        name = f"leaf_{i:05d}.npy"
        a = np.load(tmp_path / "t" / "step_00000001" / name)
        b = np.load(tmp_path / "j" / "step_00000001" / name)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_leaves_load_as_tensors_on_the_templates_device(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32), "b": np.ones(2),
            "c": 3}
    TCK.save_checkpoint(str(tmp_path), 0, tree)
    got, _, _ = TCK.load_checkpoint(str(tmp_path), tree)
    assert got["a"].device.type == "cpu" and torch.equal(got["a"],
                                                         tree["a"])
    assert got["b"].dtype == torch.float64 and int(got["c"]) == 3


def test_load_fills_the_templates_own_tensors(tmp_path):
    """A leaf of the saved shape and dtype is written into the template's
    tensor (no second copy of the tree); another shape or dtype comes
    back as a new tensor of the saved one."""
    saved = {"w": torch.arange(6, dtype=torch.float32).view(2, 3),
             "h": torch.ones(4, dtype=torch.bfloat16),
             "n": torch.arange(3, dtype=torch.int64)}
    TCK.save_checkpoint(str(tmp_path), 0, saved)
    like = {"w": torch.zeros(2, 3, requires_grad=True),
            "h": torch.zeros(4, dtype=torch.bfloat16),
            "n": torch.zeros(3, dtype=torch.int32)}
    ptrs = {k: t.data_ptr() for k, t in like.items()}
    got, _, _ = TCK.load_checkpoint(str(tmp_path), like)
    assert got["w"] is like["w"] and got["h"] is like["h"]
    assert got["w"].data_ptr() == ptrs["w"] and got["w"].requires_grad
    assert torch.equal(like["w"].detach(), saved["w"])
    assert torch.equal(like["h"], saved["h"])
    assert got["n"] is not like["n"] and got["n"].dtype == torch.int64
    assert torch.equal(got["n"], saved["n"]) and not like["n"].any()


def test_manager_keeps_k_and_collects_tmp(tmp_path):
    root = tmp_path / "ck"
    (root / "step_00000009.tmp").mkdir(parents=True)
    mgr = TCK.CheckpointManager(str(root), keep=2, save_interval=2)
    assert not (root / "step_00000009.tmp").exists()
    assert [mgr.should_save(s) for s in (0, 1, 2, 3, 4)] == \
        [False, False, True, False, True]
    tree = {"x": torch.zeros(3)}
    for s in range(1, 5):
        tree["x"] += 1
        mgr.save(s, tree)              # async: the snapshot is taken now
    mgr.wait()
    assert TCK.list_checkpoints(str(root)) == [3, 4] == \
        JCK.list_checkpoints(str(root))
    assert mgr.latest_step() == 4
    got, step, _ = mgr.restore(tree)
    assert step == 4 and torch.equal(got["x"], torch.full((3,), 4.0))
    got, _, _ = TCK.load_checkpoint(str(root), tree, step=3)
    assert torch.equal(got["x"], torch.full((3,), 3.0))
    # an incomplete save is ignored by both packages
    (root / "step_00000010.tmp").mkdir()
    assert TCK.list_checkpoints(str(root)) == [3, 4]


def test_tree_mismatch_raises(tmp_path):
    TCK.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="tree mismatch"):
        TCK.load_checkpoint(str(tmp_path), {"b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        TCK.load_checkpoint(str(tmp_path / "none"), {"a": torch.zeros(2)})


@pytest.mark.parametrize("payload", ["{not json", '["a list"]',
                                     '{"paths": []}'])
def test_foreign_manifest_raises(tmp_path, payload):
    d = tmp_path / "step_00000001"
    d.mkdir()
    (d / "manifest.json").write_text(payload)
    with pytest.raises(ValueError, match="not a checkpoint manifest"):
        TCK.read_metadata(str(tmp_path))


def test_async_save_error_surfaces(tmp_path):
    root = tmp_path / "ck"
    mgr = TCK.CheckpointManager(str(root))
    os.rmdir(root)
    root.write_text("a file where the directory was")
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                         # the error is raised once


# -- the trainer --------------------------------------------------------

def _smoke_cfg():
    return make_config("qwen2.5-3b", smoke=True, backend="ref",
                       analog_mode="train", analog_device="paper")


def _fresh(cfg, ckpt_dir=None, total=3):
    return TTRAIN.build_trainer(cfg, torch.device("cpu"), steps=total,
                                batch=2, seq=8, log=None,
                                ckpt_dir=ckpt_dir, ckpt_every=1)


def _assert_states_equal(a, b):
    for x, y in zip(TO.tree_leaves(a.params), TO.tree_leaves(b.params)):
        assert torch.equal(x, y)
    for x, y in zip(TO.tree_leaves(a.opt_state.mu),
                    TO.tree_leaves(b.opt_state.mu)):
        assert torch.equal(x, y)
    for x, y in zip(TO.tree_leaves(a.opt_state.nu),
                    TO.tree_leaves(b.opt_state.nu)):
        assert torch.equal(x, y)
    assert int(a.opt_state.count) == int(b.opt_state.count)


def test_trainer_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    cfg = _smoke_cfg()
    _, full, state = _fresh(cfg)
    s_full = full.fit(state, 3)

    ck = str(tmp_path / "ck")
    _, part, state = _fresh(cfg, ck)
    part.fit(state, 2)
    assert TCK.list_checkpoints(ck) == [1, 2]
    _, resumed, state = _fresh(cfg, ck)
    # the resumed step sees the template's own tensors, restored in place
    template = TO.tree_leaves(state.params) + TO.tree_leaves(
        state.opt_state.mu) + TO.tree_leaves(state.opt_state.nu)
    seen, step_fn = [], resumed.train_step

    def spy(params, opt_state, batch, step):
        seen.append(TO.tree_leaves(params) + TO.tree_leaves(opt_state.mu)
                    + TO.tree_leaves(opt_state.nu))
        return step_fn(params, opt_state, batch, step)

    resumed.train_step = spy
    s_res = resumed.fit(state, 3)
    assert len(seen) == 1 and len(seen[0]) == len(template)
    assert all(a is b for a, b in zip(seen[0], template))
    assert [h["step"] for h in resumed.history] == [3]
    assert resumed.history[0]["loss"] == full.history[2]["loss"]
    _assert_states_equal(s_full, s_res)
    assert TCK.list_checkpoints(ck) == [1, 2, 3]


def test_launcher_resumes_from_ckpt_dir(tmp_path, capsys):
    """``launch.train --ckpt-dir`` resumes a run stopped at step 2 and
    checkpoints the step-3 state bitwise the uninterrupted run's."""
    cfg = _smoke_cfg()
    _, full, state = _fresh(cfg)
    s_full = full.fit(state, 3)
    ck = str(tmp_path / "ck")
    _, part, state = _fresh(cfg, ck)
    part.fit(state, 2)
    out = TTRAIN.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "8",
                       "--analog-mode", "train", "--analog-device", "paper",
                       "--ckpt-dir", ck])
    assert "resumed from step 2" in capsys.readouterr().out
    assert out["losses"] == [full.history[2]["loss"]]
    assert out["ckpt_dir"] == ck
    _, fresh, template = _fresh(cfg)
    tree, step, _ = TCK.load_checkpoint(
        ck, {"params": template.params, "opt": template.opt_state})
    assert step == 3
    _assert_states_equal(s_full, TTRAIN.TrainState(tree["params"],
                                                   tree["opt"]))
