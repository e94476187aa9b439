"""repro_torch stands on its own: it imports neither JAX nor the JAX
package, and its entry point runs on the GPU unless asked for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import (kernel_bench, kernel_tune, lstm_eval, serve,
                                 train)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for name in ("launch.lstm_eval", "launch.serve", "nn.moe",
                 "kernels.nladc", "kernels.flash_decode",
                 "kernels.fused_matmul_nladc",
                 "configs.moonshot_v1_16b_a3b", "configs.deepseek_moe_16b",
                 "kernels.analog_tile", "kernels.tune",
                 "launch.kernel_tune", "launch.kernel_bench",
                 "launch.lstm_train", "train.optim", "launch.train",
                 "launch.steps", "train.loop", "data.pipeline",
                 "core.circuit", "ckpt.checkpoint", "serve.lifecycle",
                 "serve.engine", "nn.model"):
        assert "repro_torch." + name in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "    if k == 'jax' or k.startswith('jax.') or k == 'repro'\n"
        "    or k.startswith('repro.') or k == 'ml_dtypes'\n"
        "    or k.startswith('ml_dtypes.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro(\.|\s+import)(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("    from jax import random", True), ("import repro", True),
    ("from repro.core import nladc", True), ("from repro import x", True),
    ("import repro_torch", False), ("from repro_torch.core import x", False),
    ("import jaxlib_free_name_is_fine", False)])
def test_import_scan_pattern(line, bad):
    assert bool(_FORBIDDEN.search(line)) == bad


def test_lstm_eval_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lstm_eval.main(["--config", "kws_lstm"])


def test_serve_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "qwen2.5-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                    "--override", "kv_cache_dtype=int8"])
    out = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                      "--requests", "1", "--max-new", "1"])
    assert out["device"] == "cpu" and out["backend"] == "ref"


def test_lm_train_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])
    out = train.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                      "--steps", "1", "--batch", "1", "--seq", "8"])
    assert out["device"] == "cpu" and out["backend"] == "ref"


def test_kernel_launchers_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        kernel_tune.main(["--quick"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        kernel_bench.main([])
    out = kernel_bench.main(["--device", "cpu"])
    assert out["device"] == "cpu" and out["shapes"][0]["nladc_us"] is None


def test_lstm_eval_runs_on_cpu(capsys):
    out = lstm_eval.main(["--config", "kws_lstm", "--device", "cpu",
                          "--batches", "1", "--batch", "4"])
    assert out["launches"] == 0 and out["device"] == "cpu"
    assert 0.0 <= out["accuracy"] <= 1.0 and out["nll"] > 0
    header = capsys.readouterr().out.splitlines()[0]
    assert "TF32 off" in header and "backend ref" in header
