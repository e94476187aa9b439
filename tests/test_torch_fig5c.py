"""Fig. 5c on the port (``repro_torch.launch.lstm_train.fig5c`` and
``train_eval_bpc``) against ``benchmarks/fig5c_ptb.py``.

* The float row (``enabled=False``: no quantizer, no noise) from the
  reference's own ``classifier_init(PRNGKey(0))`` at hidden 16, projection
  8, and at the paper's 2016 / 504, T 8, 2 Adam steps: the port's BPC
  within rtol 1e-5 of the reference ``train_eval_bpc``'s (both train on
  ``CharCorpus`` batches 0 and 1 and evaluate on batches 10,000-10,003; a
  few float32 ulps of the sum order).
* ``train_eval_bpc`` trains a copy of the ``params`` it is given, so
  every ``fig5c`` row starts from the same weights.
* The ``--fig5c`` entry point end to end on the CPU at a tiny width: four
  finite BPCs, a loss curve a row, the benchmark's ordering check.
* ``--fig5c`` refuses the flags of a single training run, and
  ``--hidden`` / ``--proj`` refuse to run without it.
* ``--kernel-blocks`` and ``--kernel-cache`` on ``lstm_train`` and
  ``lstm_eval``: a bad spec or a missing file exits with the parser's
  error, as on ``launch.serve``.
"""

import jax
import numpy as np
import pytest
import torch

from benchmarks import fig5c_ptb as JF
from repro.data.pipeline import CharCorpus
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.launch import lstm_eval, lstm_train
from repro_torch.nn import lstm as TL
from repro_torch.train import optim

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

CPU = torch.device("cpu")


def _float_row_parity(hidden, proj):
    seq, steps = 8, 2
    spec = JF._spec(5, "exact", enabled=False, hidden=hidden, proj=proj)
    corpus = CharCorpus(seq_len=seq, batch=16, corpus_len=60_000)
    want = JF.train_eval_bpc(spec, corpus, steps=steps)
    params = convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, JL.classifier_init(jax.random.PRNGKey(0), spec, 50)))
    exact = lstm_train.analog_config("exact", enabled=False, backend="ref")
    got = lstm_train.train_eval_bpc(exact, exact, CPU, hidden=hidden,
                                    proj=proj, steps=steps, seq=seq,
                                    params=params)
    assert len(got["losses"]) == steps
    np.testing.assert_allclose(got["bpc"], want, rtol=1e-5)


def test_float_row_matches_the_reference_bpc():
    _float_row_parity(16, 8)


def test_float_row_matches_the_reference_bpc_at_full_width():
    """The paper's widths (LSTM 2016, projection 504), where the chip's
    full-mode float row ends above a uniform guess's BPC."""
    _float_row_parity(2016, 504)


def test_every_fig5c_row_starts_from_the_callers_weights():
    """``fig5c`` hands every row the same ``params``: training one row
    leaves the tree as it was, so a second row from it trains the same."""
    gen = torch.Generator().manual_seed(3)
    exact = lstm_train.analog_config("exact", enabled=False, backend="ref")
    spec = TL.LSTMSpec(n_in=128, n_hidden=8, n_proj=4, analog=exact)
    params = TL.classifier_init(gen, spec, 50)
    before = optim.tree_map(torch.clone, params)
    bpcs = []
    for _ in range(2):
        got = lstm_train.train_eval_bpc(exact, exact, CPU, hidden=8, proj=4,
                                        steps=2, seq=4, params=params)
        assert got["losses"][0] != got["losses"][-1]
        bpcs.append(got["bpc"])
        for a, b in zip(optim.tree_leaves(params),
                        optim.tree_leaves(before)):
            assert torch.equal(a, b)
    assert bpcs[0] == bpcs[1]


def test_fig5c_entry_point_on_the_cpu(capsys):
    out = lstm_train.main(["--fig5c", "quick", "--device", "cpu",
                           "--hidden", "8", "--proj", "4"])
    assert out["steps"] == 80 and out["seq"] == 64
    assert set(out["rows"]) == {"float", "5b", "4b", "3b"}
    assert all(np.isfinite(v) for v in out["rows"].values())
    assert all(len(c) == 80 and np.all(np.isfinite(c))
               for c in out["losses"].values())
    held = out["rows"]["float"] <= out["rows"]["5b"] + 0.05 \
        and out["rows"]["5b"] <= out["rows"]["3b"] + 0.05
    assert out["ordering_held"] == held
    assert "[fig5c] 3b BPC" in capsys.readouterr().out


@pytest.mark.parametrize("launcher", [lstm_train, lstm_eval])
def test_kernel_flags_exit_with_the_parsers_error(launcher, tmp_path,
                                                  capsys):
    base = ["--config", "kws_lstm", "--device", "cpu"]
    with pytest.raises(SystemExit):
        launcher.main(base + ["--kernel-blocks", "nladc=1x2x3"])
    assert "--kernel-blocks" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launcher.main(base + ["--kernel-cache",
                              str(tmp_path / "missing.json")])
    assert "--kernel-cache" in capsys.readouterr().err


@pytest.mark.parametrize("argv,flag", [
    (["--fig5c", "full", "--steps", "10"], "--steps"),
    (["--fig5c", "quick", "--config", "kws_lstm"], "--config"),
    (["--fig5c", "quick", "--analog-device", "paper-ir"], "--analog-device"),
    (["--hidden", "8"], "--hidden"),
])
def test_fig5c_flags_that_would_be_ignored_exit_with_the_parsers_error(
        argv, flag, capsys):
    with pytest.raises(SystemExit):
        lstm_train.main(argv + ["--device", "cpu"])
    assert flag in capsys.readouterr().err
