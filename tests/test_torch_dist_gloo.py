"""The distribution layer across ranks: repro_torch.dist on 4 gloo ranks
against the JAX package's ``shard_map`` code on 4 fake XLA devices, the
same per-rank inputs and weights on both sides.

One module fixture runs the reference once, in a subprocess with 4 host
devices (``repro.subproc``), writing every output to an ``.npz``; beside
it, the port runs once: 4 processes (``torch.multiprocessing``), a gloo
group over a ``FileStore`` in a temporary directory (no fixed port: test
workers run side by side), every wait bounded so a hang fails within a
minute.  Each check below reads those outputs:

* ``hierarchical_grad_allreduce`` over (pod 2 x data 2), a ragged leading
  dim and a scalar: equal to the flat all-reduce and to the reference's,
  rtol 1e-6;
* ``compressed_psum`` (a tree: a block that is zero on one rank only,
  zeros, bf16) and ``compressed_psum_ef`` over two steps: bitwise the
  reference's, and ``sum(reduced) + sum(residuals) == sum(x)``;
* EP: deepseek-moe-16b SMOKE, float32, analog off, capacity factor 8, B 4
  x S 16 on (data 2 x model 2): logits rel < 2e-4 against the port's GSPMD
  ``moe_apply`` and the reference's EP output (``tests/test_dist.py``'s
  bound); the load-balance loss rtol 1e-5; each rank holds half the
  experts, and the parameter gradients (summed over the data ranks; the
  experts' gathered from their owners) are within rtol 2e-4 / atol 2e-5
  of the GSPMD path's; at S 15, which does not split over model, the
  fallback on the gathered experts gives the GSPMD logits;
* the DP step, psum, with uneven label masking: equal to the port's
  ``make_train_step`` and the reference's DP step to the bounds of
  ``tests/test_dist_edges.py`` (tokens exact, loss 1e-5, grad_norm 1e-4,
  params 1e-5); hierarchical within 1e-6 of psum;
* the DP step, int8 with error feedback, two steps: the residual is
  populated, carried and each rank's own; params within 1e-4 of psum's;
* one qwen2.5-3b SMOKE DP step in analog ``exact`` mode (the NL-ADC on)
  against the reference's: loss rtol 1e-5, grad_norm rtol 1e-4, params
  atol 1e-5;
* the launcher under ``torch.distributed.run --nproc-per-node 2`` with
  ``--grad-comm int8``.

The module imports neither ``jax`` nor ``repro`` at its top: the ranks
import it to find their entry point.
"""

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 60
B, S = 8, 16
EP_B, EP_S = 4, 16


# -- the port's ranks ---------------------------------------------------------

def _save(out: dict, path: str) -> None:
    np.savez(path, **{k: np.asarray(v.detach().float().numpy()
                                     if torch.is_tensor(v) else v)
                      for k, v in out.items()})


def _port_lm(arch: str, tmp: str, mesh=None, analog=None, **over):
    """The port's SMOKE model of ``arch`` (its analog spec
    ``AnalogSpec(**analog)``, as the reference's tests build theirs) and
    the reference's weights."""
    from repro_torch import configs as TC
    from repro_torch import convert
    from repro_torch.configs.base import AnalogSpec
    from repro_torch.nn.model import build

    cfg = TC.get_smoke(arch).replace(analog=AnalogSpec(**analog), **over)
    model = build(cfg, "cpu", mesh=mesh)
    return model, convert.load_npz(os.path.join(tmp, f"{arch}.npz"))


def _rank_hier_and_int8(rank, tmp, inp, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.dist import compress as CP

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    tree = {"a": torch.from_numpy(inp["hier_x"][rank]),
            "s": torch.tensor(inp["hier_s"][rank])}
    flat = C.grad_allreduce(tree, mesh, mode="psum", pod_axis="pod")
    hier = C.grad_allreduce(tree, mesh, mode="hierarchical", pod_axis="pod")
    out.update({"flat_a": flat["a"], "flat_s": flat["s"],
                "hier_a": hier["a"], "hier_s": hier["s"]})

    line = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    tree = {"g": torch.from_numpy(inp["cp_g"][rank]),
            "z": torch.zeros(31),
            "h": torch.from_numpy(inp["cp_h"][rank]).to(torch.bfloat16),
            "sparse": torch.from_numpy(inp["cp_sparse"][rank])}
    got = CP.compressed_psum(tree, line, ("data",))
    assert got["h"].dtype == torch.bfloat16
    out.update({f"cp_{k}": v for k, v in got.items()})
    res = torch.zeros(100)
    for k in (1, 2):
        o, res = CP.compressed_psum_ef(torch.from_numpy(inp[f"ef_g{k}"][rank]),
                                       res, line, ("data",))
        out[f"ef_o{k}"] = o
    out["ef_res"] = res


def _tree_grads(params, objective):
    from repro_torch.train import optim as TO

    leaves = TO.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(objective(), leaves)
    return leaves, list(grads)


def _rank_ep(rank, tmp, inp, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.dist.ep import place_experts

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d = mesh.get_local_rank("data")
    over = dict(dtype="float32", analog={"enabled": False},
                capacity_factor=8.0)
    ep, params = _port_lm("deepseek-moe-16b", tmp, mesh,
                          moe_impl="ep_shardmap", **over)
    params = place_experts(params, mesh)
    out["ep_expert_rows"] = params["layers"][0]["moe"]["w_gate"].shape[0]
    tokens = torch.from_numpy(inp["ep_tokens"]).long()
    ct = torch.from_numpy(inp["ep_ct"])
    rows = slice(d * EP_B // 2, (d + 1) * EP_B // 2)
    got = {}

    def objective():
        logits, aux = ep.forward(params, tokens[rows], collect_aux=True)
        got["logits"], got["aux"] = logits.detach(), aux.detach()
        return torch.sum(logits * ct[rows]) + aux

    _, grads = _tree_grads(params, objective)
    for name, g in zip(_leaf_names(params), grads):
        g = C.psum(g, mesh, ("data",))
        if name.split("/")[-1] in ("w_gate", "w_up", "w_down"):
            g = C.all_gather(g, mesh.get_group("model"))   # the owners'
        out[f"ep_grad/{name}"] = g
    out["ep_logits"] = C.all_gather(got["logits"].contiguous(),
                                    mesh.get_group("data"))
    out["ep_aux"] = got["aux"]
    # S 15 does not split over model: moe_apply on the gathered experts
    with torch.no_grad():
        out["ep_fallback_logits"] = ep.forward(params, tokens[:, :EP_S - 1])
    if rank == 0:
        gs, params = _port_lm("deepseek-moe-16b", tmp, **over)
        want = {}

        def full():
            logits, aux = gs.forward(params, tokens, collect_aux=True)
            want["logits"], want["aux"] = logits.detach(), aux.detach()
            return torch.sum(logits * ct) + aux

        _, grads = _tree_grads(params, full)
        out.update({f"gs_grad/{n}": g for n, g in
                    zip(_leaf_names(params), grads)})
        out["gs_logits"], out["gs_aux"] = want["logits"], want["aux"]
        with torch.no_grad():
            out["gs_fallback_logits"] = gs.forward(params,
                                                   tokens[:, :EP_S - 1])


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``optim.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _batch(inp, key, rows=None):
    b = {"tokens": torch.from_numpy(inp[f"{key}_tokens"]).long(),
         "labels": torch.from_numpy(inp[f"{key}_labels"]).long()}
    return b if rows is None else {k: v[rows] for k, v in b.items()}


def _rank_dp(rank, tmp, inp, out):
    from repro_torch.ft.elastic import build_mesh, plan_for_devices
    from repro_torch.launch import steps as TS
    from repro_torch.train import optim as TO

    mesh = build_mesh(plan_for_devices(WORLD, global_batch=B,
                                       model_parallel=1))
    rows = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
    over = dict(dtype="float32", analog={"enabled": False})

    def run(mode, key, steps=1, **kw):
        model, params = _port_lm("qwen2.5-3b", tmp, **{**over, **kw})
        opt = TS.make_optimizer(model.cfg)
        step = TS.make_dp_train_step(model, opt, mesh, grad_comm=mode)
        state = TS.make_dp_opt_state(opt, params, grad_comm=mode)
        for k in range(steps):
            params, state, m = step(params, state, _batch(inp, key, rows), k)
            if mode == "int8":
                out[f"{key}_int8_res{k}"] = TO.global_norm(state["ef"])
        return params, state, m

    def keep(prefix, params, m):
        out.update({f"{prefix}/{n}": p for n, p in
                    zip(_leaf_names(params), TO.tree_leaves(params))})
        out.update({f"{prefix}_m/{k}": v for k, v in m.items()})

    params, _, m = run("psum", "mask")
    keep("dp_psum", params, m)
    params, _, m = run("hierarchical", "mask")
    keep("dp_hier", params, m)
    params, _, m = run("psum", "even", steps=2)
    keep("even_psum", params, m)
    params, state, m = run("int8", "even", steps=2)
    keep("even_int8", params, m)
    out["even_int8_res_rank"] = torch.full((), float(rank))
    out["even_int8_res_first"] = TO.tree_leaves(state["ef"])[0].reshape(-1)[:64]
    exact = {"analog": {"enabled": True, "mode": "exact"}}
    params, _, m = run("psum", "mask", **{**over, **exact})
    keep("exact_psum", params, m)
    if rank == 0:
        model, params = _port_lm("qwen2.5-3b", tmp, **over)
        opt = TS.make_optimizer(model.cfg)
        params, _, m = TS.make_train_step(model, opt)(
            params, opt.init(params), _batch(inp, "mask"), 0)
        keep("plain", params, m)


def _rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
        out = {}
        _rank_hier_and_int8(rank, tmp, inp, out)
        _rank_ep(rank, tmp, inp, out)
        _rank_dp(rank, tmp, inp, out)
        _save(out, os.path.join(tmp, f"rank{rank}.npz"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp: str, world: int = WORLD, timeout: float = 240.0):
    """``fn(rank, tmp)`` on ``world`` spawned processes; raises if a rank
    fails or the whole run passes ``timeout`` seconds (then every rank is
    terminated)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(tmp,), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


# -- the reference's run ------------------------------------------------------

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np, sys
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.configs.base import AnalogSpec
from repro.dist.collectives import hierarchical_grad_allreduce
from repro.dist.compress import compressed_psum, compressed_psum_ef
from repro.ft.elastic import build_mesh, plan_for_devices
from repro.launch.steps import (make_dp_opt_state, make_dp_train_step,
                                make_optimizer, make_train_step)
from repro.nn.model import build

tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}
devs = np.array(jax.devices())

mesh = Mesh(devs.reshape(2, 2), ("pod", "data"))
tree = {"a": jnp.asarray(inp["hier_x"]), "s": jnp.asarray(inp["hier_s"])}
spec = {"a": P(("pod", "data")), "s": P(("pod", "data"))}
hier = jax.jit(jax.shard_map(
    lambda t: hierarchical_grad_allreduce(jax.tree.map(lambda x: x[0], t),
                                          data_axis="data", pod_axis="pod"),
    mesh=mesh, in_specs=(spec,), out_specs={"a": P(), "s": P()},
    check_vma=False))(tree)
out["hier_a"], out["hier_s"] = hier["a"], hier["s"]

line = Mesh(devs, ("data",))
tree = {"g": jnp.asarray(inp["cp_g"]), "z": jnp.zeros((4, 31)),
        "h": jnp.asarray(inp["cp_h"]).astype(jnp.bfloat16),
        "sparse": jnp.asarray(inp["cp_sparse"])}
got = jax.jit(jax.shard_map(
    lambda t: compressed_psum(jax.tree.map(lambda x: x[0], t), "data"),
    mesh=line, in_specs=(jax.tree.map(lambda _: P("data"), tree),),
    out_specs=jax.tree.map(lambda _: P(), tree)))(tree)
out.update({"cp_" + k: np.asarray(v, np.float32) for k, v in got.items()})
f = jax.jit(jax.shard_map(lambda g, r: compressed_psum_ef(g, r, "data"),
                          mesh=line, in_specs=(P("data"), P("data")),
                          out_specs=(P(None), P("data")), check_vma=False))
res = jnp.zeros((4, 100), jnp.float32)
for k in (1, 2):
    o, res = f(jnp.asarray(inp["ef_g%d" % k]), res)
    out["ef_o%d" % k] = o[0]
out["ef_res"] = res

mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
c0 = configs.get_smoke("deepseek-moe-16b")
cfg = c0.replace(dtype="float32", analog=AnalogSpec(enabled=False),
                 capacity_factor=8.0, moe_impl="ep_shardmap")
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
with jax.set_mesh(mesh):
    sh = NamedSharding(mesh, P("data", None))
    logits = jax.jit(model.forward)(
        params, jax.device_put(jnp.asarray(inp["ep_tokens"]), sh))
out["ep_logits"] = logits

cfg = configs.get_smoke("qwen2.5-3b").replace(
    dtype="float32", analog=AnalogSpec(enabled=False))
dmesh = build_mesh(plan_for_devices(4, global_batch=8, model_parallel=1))
batch = {"tokens": jnp.asarray(inp["mask_tokens"]),
         "labels": jnp.asarray(inp["mask_labels"])}
for name, c in (("dp", cfg), ("exact", cfg.replace(
        analog=AnalogSpec(enabled=True, mode="exact")))):
    model = build(c)
    opt = make_optimizer(c)
    params = model.init(jax.random.PRNGKey(0))
    p2, _, m2 = jax.jit(make_dp_train_step(model, opt, dmesh,
                                           grad_comm="psum"))(
        params, opt.init(params), batch, 0)
    for k, v in m2.items():
        out[name + "_m/" + k] = v
    for path, leaf in jax.tree_util.tree_leaves_with_path(p2):
        out[name + "/" + "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                                  for q in path)] = leaf
np.savez(tmp + "/reference.npz",
         **{k: np.asarray(v, np.float32) for k, v in out.items()})
print("REFERENCE OK")
"""


def _inputs(tmp: str) -> None:
    """Every per-rank input, and both models' reference weights in the
    JAX layout (``convert.save_npz``), drawn with numpy or from the
    reference's seed-0 init."""
    import jax

    from repro import configs as JC
    from repro.configs.base import AnalogSpec
    from repro.nn.model import build
    from repro_torch import convert

    rng = np.random.default_rng(0)
    sparse = (1e-3 * rng.normal(size=(WORLD, 3 * 2048 + 5))) \
        .astype(np.float32)
    sparse[0, :2048] = 0.0                # a block zero on one rank only
    g = rng.normal(size=(WORLD, 2, 4096)).astype(np.float32)
    g[2, 1] = 0.0
    qcfg = JC.get_smoke("qwen2.5-3b")
    mask_tokens = rng.integers(0, qcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, qcfg.vocab, (B, S)).astype(np.int32)
    masked = np.concatenate([rng.random((B // 2, S)) < 0.9,
                             rng.random((B // 2, S)) < 0.1])
    masked[:2] = True                      # rank 0 holds no valid label
    dcfg = JC.get_smoke("deepseek-moe-16b")
    inputs = {
        "hier_x": rng.normal(size=(WORLD, 5, 6)).astype(np.float32),
        "hier_s": rng.normal(size=(WORLD,)).astype(np.float32),
        "cp_g": g, "cp_h": rng.normal(size=(WORLD, 1000)).astype(np.float32),
        "cp_sparse": sparse,
        "ef_g1": rng.normal(0, 1, (WORLD, 100)).astype(np.float32),
        "ef_g2": rng.normal(0, 3e-3, (WORLD, 100)).astype(np.float32),
        "ep_tokens": rng.integers(0, dcfg.vocab, (EP_B, EP_S)).astype(
            np.int32),
        "ep_ct": rng.normal(size=(EP_B, EP_S, dcfg.padded_vocab)).astype(
            np.float32),
        "mask_tokens": mask_tokens,
        "mask_labels": np.where(masked, -1, labels).astype(np.int32),
        "even_tokens": mask_tokens, "even_labels": labels,
    }
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    for arch, cfg in (("qwen2.5-3b", qcfg), ("deepseek-moe-16b", dcfg)):
        jp = build(cfg.replace(dtype="float32", analog=AnalogSpec(
            enabled=False))).init(jax.random.PRNGKey(0))
        convert.save_npz(os.path.join(tmp, f"{arch}.npz"),
                         jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def runs():
    """(reference outputs, the port's outputs per rank, inputs): the
    reference's subprocess and the port's ranks run side by side."""
    from repro.subproc import _SRC

    with tempfile.TemporaryDirectory(prefix="dist_gloo_") as tmp:
        _inputs(tmp)
        env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        ref = subprocess.Popen([sys.executable, "-c", REFERENCE, tmp],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        try:
            run_ranks(_rank_main, tmp)
            stdout, stderr = ref.communicate(timeout=300)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
        assert ref.returncode == 0 and "REFERENCE OK" in stdout, \
            stderr[-3000:]
        want = dict(np.load(os.path.join(tmp, "reference.npz")))
        port = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(WORLD)]
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
    return want, port, inputs


def test_hierarchical_equals_flat_and_reference(runs):
    want, port, inp = runs
    for r in range(WORLD):
        for k in ("a", "s"):
            np.testing.assert_allclose(port[r][f"hier_{k}"],
                                       port[r][f"flat_{k}"], rtol=1e-6)
            np.testing.assert_allclose(port[r][f"hier_{k}"],
                                       want[f"hier_{k}"], rtol=1e-6)
    np.testing.assert_allclose(port[0]["flat_a"], inp["hier_x"].sum(0),
                               rtol=1e-6)


def test_compressed_psum_bitwise_reference(runs):
    want, port, inp = runs
    for r in range(WORLD):
        for k in ("g", "z", "h", "sparse"):
            np.testing.assert_array_equal(port[r][f"cp_{k}"],
                                          want[f"cp_{k}"], err_msg=k)
    assert not port[0]["cp_z"].any()
    # the block that is zero on rank 0 keeps the others' small values
    small = inp["cp_sparse"][1:, :2048].sum(0)
    assert np.abs(port[0]["cp_sparse"][:2048]).max() > 0
    scale = np.abs(inp["cp_sparse"][:, :2048]).max() / 127.0
    assert np.abs(port[0]["cp_sparse"][:2048] - small).max() \
        <= WORLD * scale / 2 + 1e-9


def test_compressed_psum_ef_bitwise_and_identity(runs):
    want, port, inp = runs
    for r in range(WORLD):
        for k in ("ef_o1", "ef_o2"):
            np.testing.assert_array_equal(port[r][k], want[k], err_msg=k)
        np.testing.assert_array_equal(port[r]["ef_res"], want["ef_res"][r])
    total = inp["ef_g1"].sum(0) + inp["ef_g2"].sum(0)
    lhs = port[0]["ef_o1"] + port[0]["ef_o2"] \
        + sum(port[r]["ef_res"] for r in range(WORLD))
    assert np.abs(lhs - total).max() < 1e-5


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_ep_matches_gspmd_and_reference(runs):
    want, port, _ = runs
    gs = port[0]["gs_logits"]
    for r in range(WORLD):
        assert _rel(port[r]["ep_logits"], gs) < 2e-4
        assert _rel(port[r]["ep_logits"], want["ep_logits"]) < 2e-4
        np.testing.assert_allclose(port[r]["ep_aux"], port[0]["gs_aux"],
                                   rtol=1e-5)


def test_ep_fallback_gathers_placed_experts(runs):
    """At S 15, which does not split over model, every rank gathers its
    group's experts and runs ``moe_apply``: the GSPMD logits, rel < 2e-4."""
    _, port, _ = runs
    for r in range(WORLD):
        assert _rel(port[r]["ep_fallback_logits"],
                    port[0]["gs_fallback_logits"]) < 2e-4


def test_ep_grads_match_gspmd(runs):
    """Each rank holds and differentiates its own experts (half the
    stacks); their gradients gathered over model, and the router's and the
    rest summed over data, are the GSPMD path's."""
    _, port, _ = runs
    names = [k[len("gs_grad/"):] for k in port[0] if k.startswith("gs_grad/")]
    assert any(n.endswith("w_gate") for n in names)
    assert all(int(port[r]["ep_expert_rows"]) * 2
               == port[0]["gs_grad/layers/0/moe/w_gate"].shape[0]
               for r in range(WORLD))
    for r in range(WORLD):
        for n in names:
            np.testing.assert_allclose(port[r][f"ep_grad/{n}"],
                                       port[0][f"gs_grad/{n}"], rtol=2e-4,
                                       atol=2e-5, err_msg=n)
    router = [n for n in names if n.endswith("router")]
    assert router and np.abs(port[0][f"ep_grad/{router[0]}"]).max() > 0


def _jax_name(name):
    """The port's per-layer path ``layers/0/attn/wq/w`` -> (the reference's
    stacked path ``layers/attn/wq/w``, layer index)."""
    parts = name.split("/")
    if parts[0] == "layers":
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return name, None


def _params_close(port, prefix, want, wprefix, atol):
    n = 0
    for k, v in port.items():
        if not k.startswith(prefix + "/"):
            continue
        name, layer = _jax_name(k[len(prefix) + 1:])
        w = want[f"{wprefix}/{name}"]
        w = w if layer is None else w[layer]
        np.testing.assert_allclose(v, w, rtol=0, atol=atol, err_msg=k)
        n += 1
    assert n > 0


def test_dp_psum_uneven_masking(runs):
    want, port, inp = runs
    plain = port[0]
    valid = inp["mask_labels"] >= 0
    assert not valid[:2].any()            # rank 0's share is 0
    for r in range(WORLD):
        m = {k: float(port[r][f"dp_psum_m/{k}"]) for k in
             ("tokens", "loss", "grad_norm")}
        assert m["tokens"] == float(plain["plain_m/tokens"]) \
            == float(want["dp_m/tokens"]) == valid.sum()
        assert abs(m["loss"] - float(plain["plain_m/loss"])) < 1e-5
        assert abs(m["loss"] - float(want["dp_m/loss"])) < 1e-5
        assert abs(m["grad_norm"] - float(plain["plain_m/grad_norm"])) < 1e-4
        assert abs(m["grad_norm"] - float(want["dp_m/grad_norm"])) < 1e-4
        for k, v in port[r].items():
            if k.startswith("dp_psum/"):
                np.testing.assert_allclose(
                    v, plain["plain/" + k[len("dp_psum/"):]], rtol=0,
                    atol=1e-5, err_msg=k)
                np.testing.assert_allclose(
                    v, port[r]["dp_hier/" + k[len("dp_psum/"):]], rtol=1e-6,
                    atol=1e-7, err_msg=k)
        _params_close(port[r], "dp_psum", want, "dp", 1e-5)


def test_dp_int8_error_feedback(runs):
    _, port, _ = runs
    norms = [float(port[r]["even_int8_res0"]) for r in range(WORLD)]
    assert min(norms) > 0
    assert all(float(port[r]["even_int8_res1"]) > 0 for r in range(WORLD))
    firsts = [port[r]["even_int8_res_first"] for r in range(WORLD)]
    assert any(not np.array_equal(firsts[0], f) for f in firsts[1:])
    for r in range(WORLD):
        dmax = max(np.abs(v - port[r]["even_psum/" + k[len("even_int8/"):]])
                   .max() for k, v in port[r].items()
                   if k.startswith("even_int8/"))
        assert dmax < 1e-4, dmax
        assert abs(float(port[r]["even_int8_m/loss"])
                   - float(port[r]["even_psum_m/loss"])) < 1e-2


def test_dp_exact_mode_matches_reference(runs):
    want, port, _ = runs
    for r in range(WORLD):
        loss = float(port[r]["exact_psum_m/loss"])
        np.testing.assert_allclose(loss, float(want["exact_m/loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(port[r]["exact_psum_m/grad_norm"]),
                                   float(want["exact_m/grad_norm"]),
                                   rtol=1e-4)
        assert float(port[r]["exact_psum_m/tokens"]) \
            == float(want["exact_m/tokens"])
        _params_close(port[r], "exact_psum", want, "exact", 1e-5)


def test_launcher_under_torchrun():
    """``--grad-comm int8`` on 2 gloo ranks through
    ``torch.distributed.run --standalone`` (its rendezvous on a free local
    port): rank 0 prints the run, with the residual's norm."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--batch",
         "2", "--seq", "16", "--steps", "2", "--grad-comm", "int8"],
        capture_output=True, text=True, env=env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs_json = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
    assert len(runs_json) == 1, proc.stdout
    out = runs_json[0]
    assert out["world"] == 2 and out["grad_comm"] == "int8"
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert out["ef_norm"] > 0
    assert "over 2 ranks" in proc.stdout
