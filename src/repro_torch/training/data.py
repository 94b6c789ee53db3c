"""Deterministic synthetic data pipeline with exact-resume iterator state.

Generates token streams with enough structure for a ~100M model to visibly
learn (repeated n-gram motifs + Zipfian unigrams), sharded per data-parallel
rank. The iterator exposes ``state_dict()`` / ``load_state_dict()`` so a
restored checkpoint resumes on the exact batch it would have seen — part of
the fault-tolerance contract (checkpoint/restart reproduces the loss curve).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticTokenStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_motifs: int = 64
    motif_len: int = 8
    motif_prob: float = 0.5
    zipf_alpha: float = 1.2


class SyntheticTokenStream:
    """Iterator of {tokens, labels} with exact-resume support."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        self._motifs = base.integers(
            0, cfg.vocab_size, size=(cfg.num_motifs, cfg.motif_len)
        )
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._unigram = p / p.sum()
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError("resuming a stream with a different seed")
        self.step = int(state["step"])

    def _gen(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._unigram)
        # paste motifs at random offsets so there is learnable structure
        n_paste = int(cfg.motif_prob * B * (S // cfg.motif_len) / 2)
        rows = rng.integers(0, B, size=n_paste)
        offs = rng.integers(0, S + 1 - cfg.motif_len, size=n_paste)
        ids = rng.integers(0, cfg.num_motifs, size=n_paste)
        for r, o, i in zip(rows, offs, ids):
            toks[r, o : o + cfg.motif_len] = self._motifs[i]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self._gen(self.step)
        self.step += 1
        return batch
