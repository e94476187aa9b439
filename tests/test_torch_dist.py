"""The distribution layer's single-process parts: repro_torch.dist's layout
rules, int8 wire format, elastic plan and rank slices against the JAX
package's, and the data-parallel step at world size 1 (a gloo group of one
rank in this process) against the plain step.  The multi-rank parts run
in tests/test_torch_dist_gloo.py.

* ``param_specs`` on the reference's ``param_shape_specs`` of
  ``ARCH_NAMES[:10]`` against a fake 16x16 mesh (the shapes handed to the
  port as meta tensors), and on SMOKE trees at model 2 and 4;
  ``ep_param_specs``, ``batch_specs`` and ``decode_state_specs`` on SMOKE
  trees: equal to the reference's ``PartitionSpec``s as tuples.
* ``quantize_int8``, ``dequantize_int8``, ``block_scales`` and
  ``ef_compress`` bitwise the jitted reference's (jitted XLA multiplies by
  127's reciprocal and contracts the residual into one FMA; the multi-rank
  outputs come from jitted code) on the edge cases of
  ``tests/test_dist_edges.py``.
* ``plan_for_devices`` equal to the reference's.
* ``local_shard`` of the expert stacks, concatenated over the ranks, is
  the full tree; of a batch over (pod, data), the rows in rank order.
* At world size 1, ``make_dp_train_step`` under ``psum`` and
  ``hierarchical`` is bitwise ``make_train_step`` over two steps, and
  ``int8`` carries a populated residual.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as JC
from repro.dist import compress as JCOMP
from repro.dist import sharding as JSH
from repro.ft.elastic import plan_for_devices as jplan
from repro.launch.specs import param_shape_specs
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch.dist import compress as TCOMP
from repro_torch.dist import sharding as TSH
from repro_torch.ft import elastic as TEL
from repro_torch.launch import steps as TS
from repro_torch.nn.model import build as tbuild
from repro_torch.train import optim as TO

import _torch_threads  # noqa: E402,F401  (one intra-op thread)


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _meta(tree):
    """A JAX shape tree (ShapeDtypeStructs or arrays) as meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return torch.empty(tuple(tree.shape), device="meta")


def _same_specs(want, got, path=()):
    """A reference spec tree (``PartitionSpec`` leaves) equals the port's
    (tuples); returns the number of leaves compared."""
    if isinstance(want, P):
        assert tuple(want) == got, (path, want, got)
        return 1
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        return sum(_same_specs(want[k], got[k], path + (k,)) for k in want)
    assert len(want) == len(got), path
    return sum(_same_specs(w, g, path + (i,))
               for i, (w, g) in enumerate(zip(want, got)))


@pytest.mark.parametrize("arch", JC.ARCH_NAMES[:10])
def test_param_specs_match_reference_16x16(arch):
    cfg = JC.get(arch)
    sds = param_shape_specs(cfg)
    mesh = _FakeMesh(data=16, model=16)
    ssm = cfg.family == "ssm"
    want = JSH.param_specs(sds, mesh, replicate_all=ssm)
    got = TSH.param_specs(_meta(sds), mesh, replicate_all=ssm)
    n = _same_specs(want, got)
    assert n == len(jax.tree.leaves(sds))
    sharded = sum(any(e is not None for e in s) for s in
                  jax.tree.leaves(got, is_leaf=lambda s: isinstance(s,
                                                                    tuple)))
    assert (sharded > 0) == (not ssm), arch


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", JC.ARCH_NAMES[:10])
def test_smoke_specs_match_reference(arch, model):
    """Param, expert-parallel, batch and decode-state specs at SMOKE widths
    on a (pod 2, data 2, model m) mesh."""
    cfg = JC.get_smoke(arch)
    jm = jbuild(cfg)
    sds = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    mesh = _FakeMesh(pod=2, data=2, model=model)
    _same_specs(JSH.param_specs(sds, mesh), TSH.param_specs(_meta(sds), mesh))
    _same_specs(JSH.ep_param_specs(sds), TSH.ep_param_specs(_meta(sds)))
    batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "labels": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "odd": jax.ShapeDtypeStruct((6, 3), jnp.float32)}
    _same_specs(JSH.batch_specs(batch, mesh),
                TSH.batch_specs(_meta(batch), mesh))
    state = jax.eval_shape(lambda: jm.init_decode_state(4, 8))
    want = JSH.decode_state_specs(state, mesh)
    _same_specs(want, TSH.decode_state_specs(_meta(state), mesh))
    if "layers" in state:
        # the port's own layout (one dict a layer, batch on dim 0): the
        # reference's spec without its layer dim
        tstate = tbuild(TC.get_smoke(arch), device="cpu"
                        ).init_decode_state(4, 8)
        got = TSH.decode_state_specs(tstate, mesh)
        for name, spec in want["layers"].items():
            drop = tuple(spec)[1:] if tuple(spec) else ()
            assert all(layer[name] == drop for layer in got["layers"]), name


def _jit_ref(fn, *args, **kw):
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _bitwise(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_quantize_int8_edges_bitwise():
    """tests/test_dist_edges.py's edge cases: all-zero with a ragged tail,
    shorter than a block, one exact block; and a heavy-tailed draw over 64
    blocks, where the reciprocal and the division part in 3 blocks."""
    rng = np.random.default_rng(0)
    heavy = (rng.normal(size=(64 * TCOMP.BLOCK,))
             * rng.lognormal(size=(64 * TCOMP.BLOCK,))).astype(np.float32)
    cases = [np.zeros((3 * TCOMP.BLOCK + 17,), np.float32),
             np.random.default_rng(5).normal(size=(5,)).astype(np.float32),
             np.random.default_rng(TCOMP.BLOCK).normal(
                 size=(TCOMP.BLOCK,)).astype(np.float32), heavy,
             rng.normal(size=(7, 33)).astype(np.float32)]
    for x in cases:
        jq, js, jpad = jax.jit(JCOMP.quantize_int8)(jnp.asarray(x))
        tq, ts, tpad = TCOMP.quantize_int8(torch.from_numpy(x))
        assert int(jpad) == tpad
        _bitwise(jq, tq)
        _bitwise(js, ts)
        jd = _jit_ref(lambda q, s: JCOMP.dequantize_int8(q, s, tpad,
                                                         x.shape), jq, js)
        td = TCOMP.dequantize_int8(tq, ts, tpad, x.shape)
        _bitwise(jd, td)
        assert td.shape == x.shape
        if not x.any():
            assert not tq.any() and not td.any()
        else:
            assert float((td - torch.from_numpy(x)).abs().max()) \
                <= float(ts.max()) / 2 + 1e-7


@pytest.mark.parametrize("zero_fill", [1.0, 0.0])
def test_block_scales_bitwise(zero_fill):
    rng = np.random.default_rng(1)
    blocks = (rng.normal(size=(16, TCOMP.BLOCK))
              * rng.lognormal(size=(16, 1))).astype(np.float32)
    blocks[3] = 0.0
    blocks[7, :5] = 1e-30
    blocks[7, 5:] = 0.0
    want = jax.jit(lambda b: JCOMP.block_scales(b, zero_fill))(blocks)
    _bitwise(want, TCOMP.block_scales(torch.from_numpy(blocks), zero_fill))


def test_error_feedback_bitwise():
    """tests/test_dist_edges.py's EF cases (all zero is a fixed point; the
    tree rides through) and a carried residual, bitwise."""
    jtree = {"a": jnp.zeros((100,)), "b": {"c": jnp.ones((10, 10))}}
    ttree = {"a": torch.zeros(100), "b": {"c": torch.ones(10, 10)}}
    ja, jr = jax.jit(JCOMP.ef_compress)(jtree, JCOMP.ef_init(jtree))
    ta, tr = TCOMP.ef_compress(ttree, TCOMP.ef_init(ttree))
    for k in (("a",), ("b", "c")):
        jv, tv, jrv, trv = ja, ta, jr, tr
        for key in k:
            jv, tv, jrv, trv = jv[key], tv[key], jrv[key], trv[key]
        _bitwise(jv, tv)
        _bitwise(jrv, trv)
    assert not ta["a"].any() and not tr["a"].any()
    rng = np.random.default_rng(2)
    g = rng.normal(0, 1, (3, 1000)).astype(np.float32)
    res = rng.normal(0, 3e-3, (3, 1000)).astype(np.float32)
    for _ in range(2):
        ja, jr = jax.jit(JCOMP.ef_compress)(jnp.asarray(g), jnp.asarray(res))
        ta, tr = TCOMP.ef_compress(torch.from_numpy(g), torch.from_numpy(res))
        _bitwise(ja, ta)
        _bitwise(jr, tr)
        res = tr.numpy()


def test_plan_for_devices_matches_reference():
    cases = [(192, 256, 16), (100, 64, 16)]
    cases += [(n, b, m) for n in range(1, 17) for b in (1, 2, 3, 4, 6, 8, 16)
              for m in (1, 2, 4, 16)]
    for n, b, m in cases:
        want = jplan(n, global_batch=b, model_parallel=m)
        got = TEL.plan_for_devices(n, global_batch=b, model_parallel=m)
        assert got.new_shape == dict(want.new_shape), (n, b, m)
        assert got.new_data_degree == want.new_data_degree
        assert got.global_batch == b
    old = TEL.plan_for_devices(8, global_batch=16, model_parallel=4,
                               old_mesh=_FakeMesh(data=4, model=4))
    assert old.old_shape == {"data": 4, "model": 4}
    assert old.local_batch(4) == 4
    with pytest.raises(ValueError):
        old.local_batch(3)


def test_local_shard_round_trips():
    """Every rank's expert slice, concatenated over the model dim, is the
    full stack; replicated leaves are the full leaf; a batch's rows over
    (pod, data) come in rank order."""
    cfg = TC.get_smoke("deepseek-moe-16b")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tbuild(cfg, device="cpu").init(gen)
    moe = params["layers"][0]["moe"]
    mesh = _FakeMesh(data=2, model=2)
    specs = TSH.ep_param_specs(moe)
    for d in range(2):
        parts = [TSH.local_shard(moe, specs, mesh, {"data": d, "model": m})
                 for m in range(2)]
        for name in ("w_gate", "w_up", "w_down"):
            assert parts[0][name].shape[0] == moe[name].shape[0] // 2
            assert torch.equal(torch.cat([p[name] for p in parts]),
                               moe[name])
        assert torch.equal(parts[1]["router"], moe["router"])
        assert torch.equal(parts[0]["shared"]["wi_gate"]["w"],
                           moe["shared"]["wi_gate"]["w"])
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
    mesh = _FakeMesh(pod=2, data=2, model=1)
    bspec = TSH.batch_specs(batch, mesh)
    assert bspec["tokens"] == (("pod", "data"), None)
    rows = [TSH.local_shard(batch, bspec, mesh,
                            {"pod": p, "data": d, "model": 0})["tokens"]
            for p in range(2) for d in range(2)]
    assert torch.equal(torch.cat(rows), batch["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        TSH.local_shard({"w": torch.zeros(3, 4)}, {"w": ("model", None)},
                        _FakeMesh(model=2), {"model": 0})


class _RankMesh(_FakeMesh):
    """A fake mesh as one rank sees it: its index on every dim."""

    def __init__(self, coords, **shape):
        super().__init__(**shape)
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())      # a DeviceMesh's
        self.coords = coords

    def get_local_rank(self, name):
        return self.coords[name]


def test_place_experts_keeps_the_ranks_experts():
    """``place_experts``: each rank's expert stacks are its slice, in
    storage of their own (the full stack is not kept alive), the rest the
    given leaves; ``LM.init`` over a mesh with ``ep_shardmap`` draws the
    same bits; ``moe_apply_ep`` refuses a rank's full stacks."""
    from repro_torch.dist.ep import moe_apply_ep, place_experts

    cfg = TC.get_smoke("deepseek-moe-16b").replace(moe_impl="ep_shardmap")
    gen = torch.Generator()
    gen.manual_seed(0)
    full = tbuild(cfg, device="cpu").init(gen)
    moe = full["layers"][0]["moe"]
    parts = []
    for m in range(2):
        mesh = _RankMesh({"data": 0, "model": m}, data=1, model=2)
        placed = place_experts(full, mesh)
        gen.manual_seed(0)
        drawn = tbuild(cfg, device="cpu", mesh=mesh).init(gen)
        for a, b in zip(TO.tree_leaves(drawn), TO.tree_leaves(placed)):
            assert torch.equal(a, b)
        pm = placed["layers"][0]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            w = pm[name]
            assert w.shape[0] == moe[name].shape[0] // 2
            assert w.untyped_storage().nbytes() == w.numel() * 4
        assert pm["router"] is moe["router"]
        assert placed["embed"]["table"] is full["embed"]["table"]
        parts.append(pm)
        with pytest.raises(ValueError, match="place_experts"):
            moe_apply_ep(moe, torch.zeros(1, 4, cfg.d_model), top_k=cfg.top_k,
                         capacity_factor=2.0, act=None, mesh=mesh)
    for name in ("w_gate", "w_up", "w_down"):
        assert torch.equal(torch.cat([p[name] for p in parts]), moe[name])
    odd = _RankMesh({"model": 1}, model=3)       # 4 experts do not split 3
    assert place_experts(moe, odd)["w_gate"] is moe["w_gate"]


@pytest.mark.parametrize("mode", ["psum", "int8"])
def test_dp_launcher_trains_the_encoder_decoder(mode):
    """whisper-base SMOKE, whose loss has no load-balance term, trains
    under ``--grad-comm`` at world size 1 with its audio frames cut with
    the batch: psum with the plain run's losses and norms, bitwise; int8
    with finite losses and a populated residual."""
    from repro_torch.launch import train as TTRAIN

    argv = ["--arch", "whisper-base", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "16"]
    out = TTRAIN.main(argv + ["--grad-comm", mode])
    assert out["world"] == 1 and len(out["losses"]) == 2
    if mode == "psum":
        plain = TTRAIN.main(argv)
        assert out["losses"] == plain["losses"]
        assert out["grad_norms"] == plain["grad_norms"]
    else:
        assert np.all(np.isfinite(out["losses"])) and out["ef_norm"] > 0


@pytest.fixture
def world_one():
    """A gloo process group of one rank (this process) and its (data 1,
    model 1) mesh; destroyed after the test."""
    tmp = tempfile.mkdtemp(prefix="dist_world_one_")
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        yield TEL.build_mesh(TEL.plan_for_devices(
            1, global_batch=2, model_parallel=1))
    finally:
        dist.destroy_process_group()


def _qwen(seed=0):
    cfg = TC.get_smoke("qwen2.5-3b").replace(dtype="float32")
    model = tbuild(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    return model, model.init(gen)


def _batch(cfg, step):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    labels = rng.integers(0, cfg.vocab, (2, 8))
    labels[0, :3] = -1
    return {"tokens": torch.from_numpy(toks), "labels":
            torch.from_numpy(labels)}


def test_dp_step_at_world_one_is_the_plain_step(world_one):
    """psum and hierarchical: the same bits as ``make_train_step`` (params,
    moments and metrics) over two steps; int8: the residual is populated
    and carried, and the params stay within 1e-4 of psum's."""
    runs = {}
    for mode in ("plain", "psum", "hierarchical", "int8"):
        model, params = _qwen()
        opt = TS.make_optimizer(model.cfg)
        if mode == "plain":
            step = TS.make_train_step(model, opt)
            state = opt.init(params)
        else:
            step = TS.make_dp_train_step(model, opt, world_one,
                                         grad_comm=mode)
            state = TS.make_dp_opt_state(opt, params, grad_comm=mode)
        metrics = []
        for k in range(2):
            params, state, m = step(params, state, _batch(model.cfg, k), k)
            metrics.append(m)
            if mode == "int8":
                res = TO.tree_leaves(state["ef"])
                assert max(float(r.abs().max()) for r in res) > 0
        runs[mode] = (params, state, metrics)
    plain = runs["plain"]
    for mode in ("psum", "hierarchical"):
        params, state, metrics = runs[mode]
        for a, b in zip(TO.tree_leaves(params), TO.tree_leaves(plain[0])):
            assert torch.equal(a, b), mode
        for a, b in zip(TO.tree_leaves(state.mu), TO.tree_leaves(
                plain[1].mu)):
            assert torch.equal(a, b), mode
        for m, w in zip(metrics, plain[2]):
            assert sorted(m) == sorted(w)
            for key in w:
                assert torch.equal(m[key], w[key]), (mode, key)
    dmax = max(float((a - b).detach().abs().max()) for a, b in zip(
        TO.tree_leaves(runs["int8"][0]), TO.tree_leaves(runs["psum"][0])))
    assert dmax < 1e-4, dmax
