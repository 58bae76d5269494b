"""Traffic generation from the run's seed: token batches and decode start
tokens. Frozen here, importing nothing of the program, so that a change to
the program's own generators cannot move the benchmark's inputs."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def streams(seed: int, n: int) -> List[np.random.Generator]:
    """`n` independent generators from any whole-number seed."""
    ss = np.random.SeedSequence([seed % (1 << 32), (seed >> 32) % (1 << 32), int(seed < 0)])
    return [np.random.default_rng(s) for s in ss.spawn(n)]


def token_ids(rng: np.random.Generator, shape, vocab: int, dist: Dict) -> np.ndarray:
    """int32 token ids of `shape`: "uniform" over the vocabulary, or "zipf"
    (rank r drawn with weight r^-a; ranks map to ids through a permutation
    fixed by `perm_seed`, so every run and seed has the same hot ids)."""
    if dist["kind"] == "uniform":
        return rng.integers(0, vocab, shape, dtype=np.int64).astype(np.int32)
    if dist["kind"] == "zipf":
        w = np.arange(1, vocab + 1, dtype=np.float64) ** -dist["a"]
        perm = np.random.default_rng(dist.get("perm_seed", 0)).permutation(vocab)
        ranks = rng.choice(vocab, size=shape, p=w / w.sum())
        return perm[ranks].astype(np.int32)
    raise ValueError(f"unknown token distribution {dist['kind']!r}")
