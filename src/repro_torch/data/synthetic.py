"""Synthetic corpora with planted routing structure (a copy of
`repro/data/synthetic.py`: numpy only, so the port keeps its own).

GLUE/C4 are unavailable offline (DESIGN.md §7), so we synthesise data whose
statistics matter for SiDA:

* **domain structure**: each sequence is drawn from one of `n_domains`
  latent domains, each with its own zipf-weighted token cluster. MoE routers
  trained on this data specialise experts per domain — giving the
  *sentence-level expert sparsity* the paper observes (Figs. 2/4) — and the
  activation pattern becomes predictable from the input alone, which is what
  the hash function exploits.
* **length distributions** mimicking the paper's datasets: "sst2" (short),
  "mrpc" (mid), "multirc" (long).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

LENGTH_PROFILES = {
    # (min_len, max_len, mode) loosely matching Fig. 2/8 histograms
    "sst2": (4, 60, 12),
    "mrpc": (30, 90, 55),
    "multirc": (150, 480, 280),
}


@dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    n_domains: int = 8
    shared_frac: float = 0.2      # tokens shared across domains
    zipf_a: float = 1.3
    profile: Optional[str] = None  # variable-length profile or None (fixed len)
    pad_id: int = 0


class SyntheticLM:
    """Deterministic, seedable synthetic LM stream."""

    def __init__(self, cfg: SyntheticConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        V, D = cfg.vocab_size, cfg.n_domains
        n_shared = max(1, int(V * cfg.shared_frac))
        self.shared = np.arange(1, 1 + n_shared) % V
        per = max(1, (V - n_shared) // D)
        self.clusters = [
            (1 + n_shared + d * per + np.arange(per)) % V for d in range(D)
        ]
        ranks = np.arange(1, per + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self.zipf_w = w / w.sum()
        ranks_s = np.arange(1, n_shared + 1, dtype=np.float64)
        ws = ranks_s ** (-cfg.zipf_a)
        self.zipf_shared = ws / ws.sum()

    def _length(self) -> int:
        cfg = self.cfg
        if cfg.profile is None:
            return cfg.seq_len
        lo, hi, mode = LENGTH_PROFILES[cfg.profile]
        return int(np.clip(self.rng.triangular(lo, mode, hi), lo, cfg.seq_len))

    def sample(self, batch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tokens [B,S], labels [B,S] (-100 pad), domains [B])."""
        cfg = self.cfg
        toks = np.full((batch, cfg.seq_len), cfg.pad_id, np.int32)
        labels = np.full((batch, cfg.seq_len), -100, np.int32)
        domains = self.rng.integers(0, cfg.n_domains, size=batch)
        for b in range(batch):
            L = self._length()
            d = domains[b]
            from_shared = self.rng.random(L) < cfg.shared_frac
            seq = np.where(
                from_shared,
                self.rng.choice(self.shared, size=L, p=self.zipf_shared),
                self.rng.choice(self.clusters[d], size=L, p=self.zipf_w),
            )
            toks[b, :L] = seq
            labels[b, : L - 1] = seq[1:]
        return toks, labels, domains.astype(np.int32)

    def batches(self, batch: int, steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(steps):
            t, l, _ = self.sample(batch)
            yield t, l
