"""Host-side data pipelines: every batch is a pure function of (seed, step).

Offline stand-ins for the paper's datasets, in numpy, drawing the same
numbers as the JAX package's pipelines for the same seed:

* ``SyntheticLM``   — Zipf-distributed token stream with Markov structure
                     (so loss curves descend), the LM trainer's data;
* ``CharCorpus``   — PTB-like 50-char stream (char-LM, BPC metric);
* ``SyntheticKWS`` — GSCD-like MFCC sequences (49x40) in 12 classes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def state_dict(self) -> Dict:
        return {"step": int(self.step)}

    def load_state_dict(self, d: Dict):
        self.step = int(d["step"])


class SyntheticLM:
    """Zipf+Markov token stream: ``batch_at(step)`` is pure in (seed,
    step).  One host draws the whole batch; the reference's ``host_id`` /
    ``n_hosts`` split belongs to multi-host training (``ROADMAP.md`` queue
    A item 6), and its seed tuple keeps host 0 here."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.state = PipelineState()
        # fixed sparse Markov structure
        mix_rng = np.random.default_rng(seed)
        self._succ = mix_rng.integers(0, vocab, size=(min(vocab, 4096), 8))

    def _zipf(self, rng, size):
        # bounded zipf via inverse-cdf on a truncated harmonic series
        u = rng.random(size)
        ranks = np.exp(u * np.log(self.vocab)).astype(np.int64) - 1
        return np.clip(ranks, 0, self.vocab - 1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``tokens`` and next-token ``labels``, (global batch, seq_len)
        int32."""
        rng = np.random.default_rng((self.seed, step, 0, 0xDA7A))
        b, s = self.global_batch, self.seq_len
        toks = self._zipf(rng, (b, s + 1))
        # 50% of positions follow the Markov successor of the previous token
        follow = rng.random((b, s)) < 0.5
        prev = toks[:, :-1] % self._succ.shape[0]
        choice = rng.integers(0, self._succ.shape[1], size=(b, s))
        succ = self._succ[prev, choice]
        toks[:, 1:] = np.where(follow, succ, toks[:, 1:])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self.state.step)
        self.state.step += 1
        return batch


class CharCorpus:
    """PTB-like character stream: 50 symbols, word-ish bigram structure.

    Characters are embedded into random orthogonal vectors per the paper's
    Methods (Gram-Schmidt over N(0,1) draws) by :meth:`embeddings`.
    """

    N_CHARS = 50

    def __init__(self, seq_len: int = 128, batch: int = 8, *, seed: int = 0,
                 embed_dim: int = 128, corpus_len: int = 200_000):
        rng = np.random.default_rng(seed)
        # Bigram transition matrix with strong structure (sparse rows).
        trans = rng.random((self.N_CHARS, self.N_CHARS)) ** 8
        trans /= trans.sum(1, keepdims=True)
        stream = np.empty(corpus_len, np.int32)
        stream[0] = 0
        for i in range(1, corpus_len):
            stream[i] = rng.choice(self.N_CHARS, p=trans[stream[i - 1]])
        self._stream = stream
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.state = PipelineState()
        # Orthogonal char embeddings (paper Methods: Gram-Schmidt on N(0,1)).
        g = rng.standard_normal((embed_dim, embed_dim))
        q, _ = np.linalg.qr(g)
        self._embed = q[: self.N_CHARS].astype(np.float32)

    def embeddings(self) -> np.ndarray:
        return self._embed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, 0xC0A9))
        starts = rng.integers(0, len(self._stream) - self.seq_len - 1,
                              size=self.batch)
        toks = np.stack([self._stream[s:s + self.seq_len + 1]
                         for s in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def next_batch(self):
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b


class SyntheticKWS:
    """GSCD-like keyword spotting: 12 classes of 49x40 MFCC sequences.

    Each class is a smooth random prototype trajectory; samples are
    time-warped, amplitude-jittered noisy copies — hard enough that an
    LSTM is actually needed, separable enough that accuracy ~ paper range.
    """

    N_CLASSES = 12
    T, F = 49, 40

    def __init__(self, *, seed: int = 0):
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((self.N_CLASSES, self.T, self.F))
        # Smooth along time (moving average) for speech-like trajectories.
        kernel = np.ones(7) / 7.0
        self._proto = np.stack([
            np.stack([np.convolve(base[c, :, f], kernel, mode="same")
                      for f in range(self.F)], axis=1)
            for c in range(self.N_CLASSES)
        ]) * 2.0
        self.seed = seed

    def sample(self, rng, n: int) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, self.N_CLASSES, size=n)
        xs = np.empty((n, self.T, self.F), np.float32)
        for i, c in enumerate(labels):
            warp = rng.uniform(0.9, 1.1)
            t_idx = np.clip((np.arange(self.T) * warp).astype(int), 0,
                            self.T - 1)
            x = self._proto[c][t_idx]
            x = x * rng.uniform(0.8, 1.2)
            x = x + 0.35 * rng.standard_normal(x.shape)
            xs[i] = x
        # per-feature standardization (paper: MFCC + standardization)
        xs = (xs - xs.mean((0, 1))) / (xs.std((0, 1)) + 1e-6)
        return xs.astype(np.float32), labels.astype(np.int32)

    def splits(self, n_train: int = 2048, n_test: int = 512):
        rng = np.random.default_rng((self.seed, 1))
        xtr, ytr = self.sample(rng, n_train)
        xte, yte = self.sample(rng, n_test)
        return (xtr, ytr), (xte, yte)
