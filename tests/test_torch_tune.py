"""The port's launch-config seam (``repro_torch.kernels.tune``) against the
JAX package's block cache (``repro.kernels.tune``): the same spec grammar
and ranks, the same JSON cache and key format, the same precedence, and a
cache miss that launches exactly the kernels' earlier constants; and the
``repro_torch.launch.kernel_tune`` entry point on the CPU."""

import json
import warnings

import pytest
import torch

from repro.kernels import tune as JT
from repro_torch.kernels import tune as TT
from repro_torch.launch import kernel_tune, serve

import _torch_threads  # noqa: E402,F401  (one intra-op thread)


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    monkeypatch.delenv(TT.ENV_BLOCKS, raising=False)
    monkeypatch.delenv(TT.ENV_CACHE, raising=False)
    TT._reset_for_tests()
    yield
    TT._reset_for_tests()


CPU = torch.device("cpu")

VALID_SPECS = [
    "", " , ", "fused_matmul_nladc=128x128x512,nladc=256x512",
    "analog_tile=4x64x256", " lstm_gates = 1x256 , ",
    "nladc=8x32,nladc=4x64", "fused_matmul_nladc=1x1x1"]
INVALID_SPECS = [
    "fused_matmul_nladc", "bogus=1x2", "nladc=1x2x3", "nladc=0x32",
    "nladc=-1x32", "nladc=ax32", "nladc=", "fused_matmul_nladc=4x64",
    "analog_tile=4x64x256x1", "lstm_gates=256"]


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_parse_block_spec_agrees_with_jax(spec):
    assert TT.parse_block_spec(spec) == JT.parse_block_spec(spec)


@pytest.mark.parametrize("spec", INVALID_SPECS)
def test_parse_block_spec_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        JT.parse_block_spec(spec)
    with pytest.raises(ValueError):
        TT.parse_block_spec(spec)


def test_ranks_and_kernels_match_jax():
    assert TT.tunable_kernels() == JT.tunable_kernels()
    for k in TT.tunable_kernels():
        assert len(TT.default_blocks(k)) == len(JT.default_blocks(k))


def test_cache_json_round_trip_and_key_format(tmp_path):
    cache = TT.TuneCache(meta={"platform": "cpu"})
    e = cache.record("fused_matmul_nladc", (4, 64, 160), torch.bfloat16,
                     (2, 64, 256), device=CPU, source="proxy", score=1.0)
    assert e["blocks"] == [2, 64, 256] and e["shape"] == [4, 64, 160]
    key = "fused_matmul_nladc|4x64x160|bfloat16|cpu|plain"
    assert list(cache.entries) == [key]
    assert key == TT.cache_key("fused_matmul_nladc", (4, 64, 160),
                               torch.bfloat16, device=CPU)
    # the JAX key has the same fields in the same order
    assert JT.cache_key("fused_matmul_nladc", (4, 64, 160), "bfloat16",
                        "cpu", "plain") == key
    path = tmp_path / "cache.json"
    cache.save(str(path))
    d = json.loads(path.read_text())
    assert d["version"] == 1 and set(d) == {"version", "meta", "entries"}
    back = TT.TuneCache.load(str(path))
    assert back.to_dict() == cache.to_dict()
    assert back.lookup("fused_matmul_nladc", (4, 64, 160), torch.bfloat16,
                       CPU) == (2, 64, 256)
    assert back.lookup("fused_matmul_nladc", (4, 64, 160), torch.float32,
                       CPU) is None
    wrapped = TT.TuneCache.from_dict({"tune": d, "shapes": {}})
    assert wrapped.to_dict() == cache.to_dict()
    with pytest.raises(ValueError, match="version"):
        TT.TuneCache.from_dict({"version": 2, "entries": {}})
    with pytest.raises(ValueError, match="entries"):
        TT.TuneCache.from_dict({"meta": {}})


def _cache_with(kernel, shape, blocks, dtype=torch.float32):
    cache = TT.TuneCache()
    cache.record(kernel, shape, dtype, blocks, device=CPU)
    return cache


def test_precedence_override_env_cache_env_cache_default(monkeypatch,
                                                          tmp_path):
    shape = (4, 64)

    def resolve():
        TT.configure()        # the env vars are read again after configure
        return TT.resolve_blocks("nladc", shape, device=CPU)

    assert resolve() == TT.DEFAULT_BLOCKS["nladc"]
    env_path = tmp_path / "env.json"
    _cache_with("nladc", shape, (4, 32)).save(str(env_path))
    monkeypatch.setenv(TT.ENV_CACHE, str(env_path))
    assert resolve() == (4, 32)
    TT.set_active_cache(_cache_with("nladc", shape, (16, 64)))
    assert resolve() == (16, 64)
    monkeypatch.setenv(TT.ENV_BLOCKS, "nladc=2x96")
    assert resolve() == (2, 96)
    TT.set_block_overrides("nladc=1x128")
    assert resolve() == (1, 128)
    # unwinding restores each level in turn
    TT.clear_block_overrides()
    assert resolve() == (2, 96)
    monkeypatch.delenv(TT.ENV_BLOCKS)
    assert resolve() == (16, 64)
    TT.set_active_cache(None)
    assert resolve() == (4, 32)
    monkeypatch.delenv(TT.ENV_CACHE)
    assert resolve() == TT.DEFAULT_BLOCKS["nladc"]


def test_env_names_are_the_ports_own(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BLOCKS", "nladc=2x96")
    monkeypatch.setenv("REPRO_KERNEL_CACHE", "/nonexistent.json")
    assert TT.resolve_blocks("nladc", (4, 64), device=CPU) == (8, 32)
    assert TT.ENV_BLOCKS == "REPRO_TORCH_KERNEL_BLOCKS"
    assert TT.ENV_CACHE == "REPRO_TORCH_KERNEL_CACHE"


def test_a_miss_is_the_kernels_earlier_constants():
    """The launch constants the CUDA sources and wrappers had before the
    seam: 4 rows a block for the dense gate, 32 columns and a K tile of
    512; 8 warps by 32 columns for the NL-ADC; one row by 256 threads for
    the LSTM tail.  The expert gate's kernel was redesigned after the seam:
    its default is 8 capacity rows an item, a 128-column weight strip and
    64 K rows a ring stage.  So was the crossbar tile's: 16 rows an item, a
    32-column strip and 128 K rows a ring stage (its K tile had staged 512
    columns of x)."""
    TT.set_active_cache(_cache_with("nladc", (9, 9), (4, 64)))
    cases = {("fused_matmul_nladc", (4, 2048, 11008)): (4, 32, 512),
             ("nladc", (4, 64)): (8, 32),
             ("lstm_gates", (16, 2016)): (1, 256),
             ("analog_tile", (16, 632, 8064)): (16, 32, 128)}
    for (kernel, shape), want in cases.items():
        assert TT.launch_config(kernel, shape, torch.bfloat16, CPU) == want
    assert TT.launch_config("fused_matmul_nladc", (6, 2048, 1408),
                            torch.bfloat16, CPU, experts=64) == (8, 128, 64)


def test_memo_is_invalidated_by_configure(monkeypatch, tmp_path):
    shape = (4, 64, 160)
    calls = []
    real = TT._resolve

    def counting(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(TT, "_resolve", counting)

    def get():
        return TT.resolve_blocks("fused_matmul_nladc", shape, torch.float32,
                                 CPU)

    assert get() == (4, 32, 512) and get() == (4, 32, 512)
    assert len(calls) == 1                       # memoized
    TT.configure("fused_matmul_nladc=2x64x256")
    assert get() == (2, 64, 256) and len(calls) == 2
    path = tmp_path / "c.json"
    _cache_with("fused_matmul_nladc", shape, (8, 32, 1024)).save(str(path))
    TT.clear_block_overrides()
    TT.configure(cache_path=str(path))
    assert get() == (8, 32, 1024) and len(calls) == 3
    TT.set_active_cache(None)
    assert get() == (4, 32, 512) and len(calls) == 4
    # the env vars are read when a key is first resolved, again after
    # configure()
    monkeypatch.setenv(TT.ENV_BLOCKS, "fused_matmul_nladc=1x32x16")
    assert get() == (4, 32, 512) and len(calls) == 4
    TT.configure()
    assert get() == (1, 32, 16) and len(calls) == 5
    assert get() == (1, 32, 16) and len(calls) == 5


def test_a_resolved_call_runs_no_torch_op():
    TT.set_active_cache(_cache_with("fused_matmul_nladc", (4, 64, 160),
                                    (2, 64, 256)))
    args = ("fused_matmul_nladc", (4, 64, 160), torch.float32, CPU)
    assert TT.launch_config(*args) == (2, 64, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            TT.launch_config(*args)
    assert [e.key for e in prof.events()] == []


@pytest.mark.parametrize("kernel,requested,applied", [
    ("fused_matmul_nladc", (128, 128, 500), (8, 64, 256)),
    ("analog_tile", (2, 33, 8), (4, 32, 16)),
    ("nladc", (64, 1000), (16, 256)),
    ("nladc", (2, 100), (4, 64)),
    ("lstm_gates", (3, 1000), (2, 512))])
def test_clamp_warns_once_and_notes_the_cache(kernel, requested, applied):
    cache = TT.TuneCache()
    TT.set_active_cache(cache)
    shape = (4, 64, 160) if len(requested) == 3 else (4, 64)
    with pytest.warns(TT.KernelBlockClampWarning, match="clamped"):
        assert TT.launch_config(kernel, shape, torch.float32, CPU,
                                requested) == applied
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TT.launch_config(kernel, shape, torch.float32, CPU,
                                requested) == applied
    e = cache.entries[TT.cache_key(kernel, shape, device=CPU)]
    assert e["clamped"] == {"requested": list(requested),
                            "applied": list(applied)}
    assert TT.supported(kernel, applied) == applied


@pytest.mark.parametrize("kernel,shape", [
    ("fused_matmul_nladc", (4, 2048, 11008)), ("fused_matmul_nladc",
                                              (512, 1024, 1024)),
    ("analog_tile", (16, 632, 8064)), ("analog_tile", (1, 33, 7)),
    ("nladc", (4, 64)), ("nladc", (1024, 2048)),
    ("lstm_gates", (16, 2016)), ("lstm_gates", (7, 32))])
def test_candidates_are_supported_and_hold_the_default(kernel, shape):
    """Each candidate is one the kernel the shape launches takes, the
    default among them: the dense gate at M > 8 launches the tensor-core
    GEMM, whose third extent is a ring depth (2 to 4), not a K tile."""
    cands = TT.candidates(kernel, shape)
    assert TT.default_for(kernel, shape) in cands and cands == sorted(cands)
    assert all(TT.supported(kernel, c, shape=shape) == c for c in cands)
    if kernel == "fused_matmul_nladc" and shape[0] > TT.GEMV_MAX_ROWS:
        assert all(c[2] in (2, 3, 4) for c in cands)
    elif kernel in ("fused_matmul_nladc", "analog_tile"):
        assert TT.default_for(kernel, shape) == TT.default_blocks(kernel)
        assert all(c[2] >= 16 and c[2] & (c[2] - 1) == 0 for c in cands)


@pytest.mark.parametrize("requested,applied", [
    ((16, 32, 512), (16, 32, 128)),   # the earlier kernel's default
    ((4, 64, 1024), (4, 64, 128)),
    ((8, 32, 256), (8, 32, 128)),     # a TMA box holds at most 256 rows
    ((16, 64, 48), (16, 64, 32))])
def test_an_earlier_crossbar_tile_entry_clamps_to_a_ring_depth(requested,
                                                               applied):
    """The crossbar tile's K tile is now its ring's box depth (16 to 128
    K rows); an entry written for the earlier kernel (x staged 16 to 2048
    columns at a time) clamps, with the one-time warning, to the depth
    nearest below it.  The sweep's candidates are ring depths."""
    shape = (16, 632, 8064)
    with pytest.warns(TT.KernelBlockClampWarning, match="clamped"):
        assert TT.launch_config("analog_tile", shape, torch.bfloat16, CPU,
                                requested) == applied
    assert {c[2] for c in TT.candidates("analog_tile", shape)} == \
        {32, 64, 128}


@pytest.mark.parametrize("requested,applied", [
    ((8, 32, 512), (8, 128, 64)),     # the earlier grouped kernel's default
    ((4, 64, 1024), (4, 128, 64)),    # an earlier sweep's winner there
    ((3, 200, 48), (2, 128, 32)),
    ((16, 512, 8), (8, 256, 16))])
def test_an_earlier_expert_gate_entry_clamps_with_one_warning(requested,
                                                              applied):
    """A cache written for the earlier grouped kernel still loads; the
    expert gate reads its entry under its own rules and clamps it, with
    the one-time warning, to the config nearest it."""
    shape = (6, 2048, 1408)
    cache = _cache_with("fused_matmul_nladc", shape, requested,
                        dtype=torch.bfloat16)
    TT.set_active_cache(TT.TuneCache.from_dict(
        json.loads(json.dumps(cache.to_dict()))))

    def gate():
        return TT.launch_config("fused_matmul_nladc", shape, torch.bfloat16,
                                CPU, experts=64)

    with pytest.warns(TT.KernelBlockClampWarning, match="clamped"):
        assert gate() == applied
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert gate() == applied
    assert TT.supported("fused_matmul_nladc", applied, experts=64) == \
        applied
    # the dense gate reads the same key under its own rules
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TT.KernelBlockClampWarning)
        assert TT.launch_config("fused_matmul_nladc", shape, torch.bfloat16,
                                CPU) == TT.supported("fused_matmul_nladc",
                                                     requested)


@pytest.mark.parametrize("shape,n_cands", [
    ((6, 2048, 1408), 24), ((7, 300, 1000), 24), ((1, 64, 80), 4),
    ((9, 64, 80), 12)])
def test_expert_gate_candidates_are_its_own(shape, n_cands):
    cands = TT.candidates("fused_matmul_nladc", shape, experts=64)
    assert TT.EXPERT_GATE_BLOCKS in cands and cands == sorted(cands)
    assert len(cands) == n_cands
    assert all(TT.supported("fused_matmul_nladc", c, experts=64) == c
               for c in cands)
    assert cands != TT.candidates("fused_matmul_nladc", shape)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 33, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_shape_picks_the_dense_gate_space(m, dtype):
    """M <= 8 launches the GEMV with its (rows, cols, k_tile) and default;
    M > 8 the tensor-core GEMM with its (rows, cols, stages) and default,
    whatever the dtype.  No config picks the kernel."""
    shape = (m, 2048, 11008)
    gemm = m > TT.GEMV_MAX_ROWS
    want = TT.GEMM_BLOCKS if gemm else TT.default_blocks("fused_matmul_nladc")
    assert TT.default_for("fused_matmul_nladc", shape) == want
    assert TT.launch_config("fused_matmul_nladc", shape, dtype, CPU) == want
    cands = TT.candidates("fused_matmul_nladc", shape)
    assert want in cands
    if gemm:
        assert {c[0] for c in cands} == {64, 128}
        assert {c[2] for c in cands} == {2, 3, 4}
        # a tuple of the GEMM's space clamps under the GEMM's rules
        assert TT.supported("fused_matmul_nladc", (256, 96, 9),
                            shape=shape) == (128, 64, 4)
    else:
        assert {c[0] for c in cands} <= {1, 2, 4, 8}
        assert TT.supported("fused_matmul_nladc", (256, 96, 9),
                            shape=shape) == (8, 64, 16)
    # the expert gate keeps its own space at any C
    assert TT.launch_config("fused_matmul_nladc", shape, dtype, CPU,
                            experts=64) == TT.EXPERT_GATE_BLOCKS


@pytest.mark.parametrize("requested,applied,what", [
    ((8, 64, 1024), TT.GEMM_BLOCKS, "rejected"),     # a GEMV sweep's entry
    ((4, 32, 512), TT.GEMM_BLOCKS, "rejected"),      # the GEMV's default
    ((256, 96, 9), (128, 64, 4), "clamped"),
    ((64, 128, 2), (64, 128, 2), None)])
def test_a_gemv_cache_entry_at_m_above_8_is_rejected(requested, applied,
                                                     what):
    """A cache from before the GEMM holds GEMV tuples (rows of x 1-8) for
    M > 8 shapes: such an entry is rejected, with the one-time warning, for
    the GEMM's default, never launched under the GEMM's meaning; a tuple
    of the GEMM's meaning is clamped into its space."""
    shape = (1024, 2048, 11008)
    cache = _cache_with("fused_matmul_nladc", shape, requested,
                        dtype=torch.bfloat16)
    TT.set_active_cache(TT.TuneCache.from_dict(
        json.loads(json.dumps(cache.to_dict()))))

    def dense():
        return TT.launch_config("fused_matmul_nladc", shape, torch.bfloat16,
                                CPU)

    if what is None:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert dense() == applied
        return
    with pytest.warns(TT.KernelBlockClampWarning, match=what):
        assert dense() == applied
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dense() == applied
    e = TT.active_cache().entries[TT.cache_key(
        "fused_matmul_nladc", shape, torch.bfloat16, device=CPU)]
    assert e["clamped"] == {"requested": list(requested),
                            "applied": list(applied)}


def test_gemm_stages_fit_the_shared_memory():
    """Every GEMM candidate leaves at least two ring stages at P 32, flat
    and banked, bfloat16 x (one part) and float32 x (three); the default
    runs four stages for bfloat16 x, two for float32."""
    from repro_torch.kernels import fused_matmul_nladc as TFM

    assert TFM.gemm_stages(TT.GEMM_BLOCKS, 32, False, 1) == 4
    assert TFM.gemm_stages(TT.GEMM_BLOCKS, 32, True, 1) == 4
    assert TFM.gemm_stages(TT.GEMM_BLOCKS, 32, True, 3) == 2
    for c in TT.candidates("fused_matmul_nladc", (1024, 2048, 11008)):
        for banked in (False, True):
            for parts in (1, 3):
                assert 2 <= TFM.gemm_stages(c, 32, banked, parts) <= c[2]
    # a 256-column ramp's strips leave no room for two float32-x stages
    assert TFM.gemm_stages(TT.GEMM_BLOCKS, 256, True, 3) < 2


def test_expert_gate_stages_fit_the_shared_memory():
    from repro_torch.kernels import fused_matmul_nladc as TFM

    def stages(blocks, p, elem, banked):
        return TFM.expert_gate_stages(blocks, 64, 6, 2048, p, elem, banked)

    # the default at the moonshot gate (P 32): 4 stages of 64 x 128
    # float32; 3 beside two banked threshold strips
    assert stages((8, 128, 64), 32, 2, False) == 4
    assert stages((8, 128, 64), 32, 2, True) == 3
    assert stages((8, 128, 16), 32, 2, True) == 8
    assert stages((8, 256, 64), 32, 2, False) == 2
    # float32 x at K 2048 leaves room for one 64 x 256 stage only
    assert stages((8, 256, 64), 32, 4, False) == 1
    x = torch.zeros((2, 8, 2048))
    w = torch.zeros((2, 2048, 256))
    thr, y_table = torch.zeros(31), torch.zeros(32)
    out = TFM.moe_fused_matmul(x, w, thr, y_table, blocks=(8, 256, 64))
    assert out.shape == (2, 8, 256)      # the CPU takes the plain version


def test_cpu_proxy_sweep_bytes_repeat():
    shapes = {"fused_matmul_nladc": [(64, 128, 256), ((4, 2048, 11008),
                                                      torch.bfloat16)],
              "analog_tile": [(128, 256, 256)], "nladc": [(128, 512)],
              "lstm_gates": [(32, 128)]}
    a = json.dumps(TT.autotune(shapes, device=CPU).to_dict(), sort_keys=True)
    b = json.dumps(TT.autotune(shapes, device=CPU).to_dict(), sort_keys=True)
    assert a == b
    entries = json.loads(a)["entries"]
    assert len(entries) == 5
    assert all(e["source"] == "proxy" for e in entries.values())
    assert "fused_matmul_nladc|4x2048x11008|bfloat16|cpu|plain" in entries
    with pytest.raises(ValueError, match="CUDA"):
        TT.autotune_kernel("nladc", (4, 64), cache=TT.TuneCache(),
                           measure="wall", device=CPU)


def test_expert_gate_entry_sweeps_from_the_expert_default():
    cache = TT.TuneCache()
    e = TT.autotune_kernel("fused_matmul_nladc", (6, 2048, 1408),
                           torch.bfloat16, cache=cache, device=CPU,
                           experts=64)
    assert e["default"] == list(TT.EXPERT_GATE_BLOCKS)
    assert e["experts"] == 64 and e["source"] == "proxy"
    assert e["candidates"] == 24
    assert TT.supported("fused_matmul_nladc", e["blocks"], experts=64) == \
        tuple(e["blocks"])
    x, w, thr, y_table = TT.kernel_inputs("fused_matmul_nladc", (3, 8, 5),
                                          torch.float32, CPU, experts=4)
    assert x.shape == (4, 3, 8) and w.shape == (4, 8, 5)
    out = TT.kernel_fn("fused_matmul_nladc", 4)(x, w, thr, y_table)
    assert out.shape == (4, 3, 5)


def test_kernel_tune_quick_on_cpu_end_to_end(tmp_path):
    out_a, out_b = tmp_path / "a.json", tmp_path / "b.json"
    res = kernel_tune.main(["--device", "cpu", "--quick", "--out",
                            str(out_a)])
    kernel_tune.main(["--device", "cpu", "--out", str(out_b)])
    assert out_a.read_bytes() == out_b.read_bytes()    # --quick by default
    assert res["platform"] == "cpu" and not res["full"]
    assert set(res["shapes"]) == {
        "fused_matmul_nladc|64x128x256|float32",
        "fused_matmul_nladc|128x256x512|float32",
        "nladc|128x512|float32", "lstm_gates|32x128|float32"}
    for cell in res["shapes"].values():
        assert cell["max_err_vs_plain"] == 0.0 and cell["us"] is None
        assert len(cell["digest"]) == 8
    par = res["parity"]
    assert par["banked"]["bitwise_equal"]
    assert par["moe_einsum"]["within_half_lsb"]
    assert par["attention"]["within_atol"]
    for k in ("moe_einsum", "attention"):            # the gradient halves
        assert 0.0 <= par[k]["grad_max_err"] <= 1e-5
    cache = TT.TuneCache.load(str(out_a))
    assert cache.lookup("nladc", (128, 512), torch.float32, CPU) == \
        tuple(res["shapes"]["nladc|128x512|float32"]["blocks"])


def test_kernel_tune_full_grid_holds_the_main_paths_shapes():
    shapes = kernel_tune.sweep_shapes(True)
    assert ((16, 632, 8064), torch.bfloat16, 0) in shapes["analog_tile"]
    assert ((128, 256, 256), torch.float32, 0) in shapes["analog_tile"]
    assert ((6, 2048, 1408), torch.bfloat16, 64) in \
        shapes["fused_matmul_nladc"]
    # qwen2.5-3b's MLP gate at the training shape, M = B x S: the GEMM
    assert ((1024, 2048, 11008), torch.bfloat16, 0) in \
        shapes["fused_matmul_nladc"]
    assert ((16, 2016), torch.float32, 0) in shapes["lstm_gates"]
    assert "analog_tile" not in kernel_tune.sweep_shapes(False)


def test_serve_kernel_flags(tmp_path, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                    "--kernel-blocks", "nladc=1x2x3"])
    assert "--kernel-blocks" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                    "--kernel-cache", str(tmp_path / "missing.json")])
    path = tmp_path / "cache.json"
    _cache_with("nladc", (4, 64), (4, 32)).save(str(path))
    out = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                      "--requests", "1", "--max-new", "1", "--kernel-cache",
                      str(path), "--kernel-blocks", "lstm_gates=2x128"])
    assert out["device"] == "cpu"
    assert TT.resolve_blocks("lstm_gates", (1, 1), device=CPU) == (2, 128)
    assert TT.resolve_blocks("nladc", (4, 64), device=CPU) == (4, 32)


def test_device_us_survives_lost_and_broken_profiler_events(monkeypatch):
    """A session that lost the last of its 20 events, or recorded one with
    a broken duration, still reads each kernel's median time times its
    launches per call; a stray event (one in the session) is not counted
    as a launch per call, and CPU events are not device time."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, us, device=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=device,
                               self_device_time_total=us)

    sessions = [
        [],                                     # nothing recorded: retried
        [ev("gemm", 4.0)] * 18 + [ev("gemm", 0.5)] +          # 19 of 20
        [ev("cmp", 1.5)] * 39 + [ev("stray", 50.0)] +
        [ev("cpu_op", 9.0, DeviceType.CPU)] * 20]

    class FakeProfile:
        def __init__(self, activities):
            self.recorded = sessions.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.recorded

    calls = []
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    us, clock = TT.device_us(lambda: calls.append(1), calls=20)
    assert (us, clock) == (4.0 + 2 * 1.5, "profiler")
    assert len(calls) == 5 + 2 * 20


def test_device_us_times_a_reading_under_the_floor_by_events(monkeypatch):
    """A profiler reading under ``floor_us`` (the launch floor, or the
    least time the work can take) is a broken one: CUDA events time the
    call instead, and the clock says what the profiler read."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [SimpleNamespace(name="gemm", device_type=DeviceType.CUDA,
                                    self_device_time_total=0.59)] * 20

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(TT, "events_us", lambda fn, calls=20: 1.5)
    assert TT.device_us(lambda: None, floor_us=0.5) == (0.59, "profiler")
    us, clock = TT.device_us(lambda: None, floor_us=0.93)
    assert us == 1.5
    assert clock == "cuda_events: profiler read 0.59 under 0.93"


# The LSTM tail's config, in the meaning its kernel gives it: lstm_gates (rows a thread takes, threads a CTA may use) -> a CTA of
# row groups x a strip of columns.

@pytest.mark.parametrize("blocks,b,h,want", [
    ((1, 256), 16, 2016, (16, 16, (126, 1))),   # PTB: one wave of 132 SMs
    ((2, 256), 16, 2016, (32, 8, (63, 1))),
    ((4, 256), 16, 2016, (64, 4, (32, 1))),
    ((1, 512), 16, 2016, (32, 16, (63, 1))),
    ((1, 128), 16, 2016, (16, 8, (126, 2))),    # B beyond one CTA's rows
    ((1, 256), 16, 32, (16, 16, (2, 1))),       # KWS: one small grid
    ((1, 256), 7, 32, (32, 7, (1, 1))),
    ((1, 256), 33, 100, (16, 16, (7, 3))),
    ((4, 512), 1, 2016, (512, 1, (4, 1)))])
def test_lstm_geometry_of_a_config(blocks, b, h, want):
    from repro_torch.kernels import lstm_cell as TLC

    assert TLC.launch_geometry(*blocks, b, h) == want


@pytest.mark.parametrize("shape", [(16, 2016), (7, 32), (16, 32), (33, 100),
                                   (1, 2016), (300, 40), (1, 1)])
def test_every_lstm_candidate_covers_the_shape(shape):
    """Each candidate's CTA fits its threads, a half-warp reads 64 bytes of
    a gate row, and the grid covers every (b, j) once."""
    from repro_torch.kernels import lstm_cell as TLC

    b, h = shape
    for rows, threads in TT.candidates("lstm_gates", shape):
        cols, groups, (gx, gy) = TLC.launch_geometry(rows, threads, b, h)
        assert cols % 16 == 0 and cols * groups <= threads <= 512
        assert (gx - 1) * cols < h <= gx * cols
        assert (gy - 1) * groups * rows < b <= gy * groups * rows
