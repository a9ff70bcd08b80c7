"""Token data pipeline: deterministic synthetic LM streams + file-backed bins.

A copy of the JAX package's ``training/data.py`` (numpy only), so that the
port imports nothing of it: the same seed gives the same batches, bit for
bit, as numpy arrays the trainer moves to the model's device.

Synthetic corpus: a mixture of Zipf-distributed unigrams and short Markov
motifs, so a ~100M model shows a real falling loss within a few hundred
steps (pure-uniform tokens would leave nothing to learn).

Beyond the JAX package's pipeline, ``feature_rows`` makes each batch carry
``features`` [batch, feature_rows, FEATURE_DIM] fp32, standard normal from a
stream of their own (the tokens stay bit for bit what they are without
them): the stub frontend's input of a VLM (pixtral-12b) or an
encoder-decoder (seamless-m4t), which the JAX trainer's data does not make.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

FEATURE_DIM = 1024  # the stub frontend's width (models.model.FRONTEND_DIM)


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.35
    path: Optional[str] = None  # .bin file of uint16/uint32 tokens
    feature_rows: int = 0  # > 0: each batch also carries "features"


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.motifs = self.rng.integers(
            0, v, (cfg.n_motifs, cfg.motif_len), dtype=np.int64
        )
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        p = p / p.sum()
        # numpy's ``choice(v, p=p)``, which the JAX package calls once a
        # token, rebuilds this cumulative sum on every call, then takes one
        # ``random()`` and a right-sided search: kept once, a token costs a
        # search, with the same stream and the same generator state
        self.cdf = p.cumsum()
        self.cdf /= self.cdf[-1]

    def _sequence(self, n: int) -> np.ndarray:
        out = np.empty(n + 1, dtype=np.int64)
        i = 0
        while i <= n:
            if self.rng.random() < self.cfg.motif_prob:
                m = self.motifs[self.rng.integers(self.cfg.n_motifs)]
                k = min(len(m), n + 1 - i)
                out[i : i + k] = m[:k]
                i += k
            else:
                u = self.rng.random()
                out[i] = int(self.cdf.searchsorted(u, side="right"))
                i += 1
        return out

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        feats = np.random.default_rng([cfg.seed, 1])
        while True:
            seqs = np.stack([self._sequence(cfg.seq_len) for _ in range(cfg.batch_size)])
            out = {
                "tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32),
            }
            if cfg.feature_rows:
                out["features"] = feats.standard_normal(
                    (cfg.batch_size, cfg.feature_rows, FEATURE_DIM),
                    dtype=np.float32)
            yield out


class BinTokenFile:
    """Memory-mapped flat token file -> LM batches (production-style)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.path is not None
        if cfg.feature_rows:
            raise ValueError("a token file carries no features")
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.rng = np.random.default_rng(cfg.seed)

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        n = len(self.tokens) - cfg.seq_len - 1
        while True:
            starts = self.rng.integers(0, n, cfg.batch_size)
            seqs = np.stack([self.tokens[s : s + cfg.seq_len + 1] for s in starts])
            yield {
                "tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32),
            }


def make_dataset(cfg: DataConfig):
    return BinTokenFile(cfg) if cfg.path else SyntheticLM(cfg)
