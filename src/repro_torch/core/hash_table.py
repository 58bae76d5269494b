"""Hash tables: the unit of work the hash-building thread produces.

A numpy-only copy of `repro/core/hash_table.py` (the port imports nothing
of `repro`).

A `HashTable` stores, for one batch, the predicted expert activation for
every token at every MoE layer plus the scaling factors α (Eq. 1 of the
paper). The inference thread consumes tables from a FIFO `queue.Queue`
(the "hash table queue" of Fig. 5).
"""
from __future__ import annotations

import queue
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class HashTable:
    """Expert activation plan for one batch.

    expert_ids: [L_moe, B, S, k] int32 — predicted experts per token/layer
    weights:    [L_moe, B, S, k] float32 — predicted scaling factors α
    """

    batch_index: int
    expert_ids: np.ndarray
    weights: np.ndarray

    @property
    def n_moe_layers(self) -> int:
        return self.expert_ids.shape[0]

    def active_experts(self, layer: int) -> np.ndarray:
        """Unique experts predicted to activate at `layer`, most-used first."""
        ids, counts = np.unique(self.expert_ids[layer], return_counts=True)
        return ids[np.argsort(-counts)].astype(np.int32)

    def activation_mass(self, layer: int, num_experts: int) -> np.ndarray:
        """Total α mass routed to each expert at `layer` — used to pick which
        experts to keep when the slot budget is tighter than the active set."""
        mass = np.zeros((num_experts,), np.float64)
        np.add.at(mass, self.expert_ids[layer].reshape(-1), self.weights[layer].reshape(-1))
        return mass

    def activation_stats(self, num_experts: int) -> Dict[str, float]:
        act = [len(self.active_experts(l)) for l in range(self.n_moe_layers)]
        return {
            "mean_active": float(np.mean(act)),
            "max_active": float(np.max(act)),
            "idle_ratio": 1.0 - float(np.mean(act)) / num_experts,
        }


class HashTableQueue:
    """FIFO queue between the hash-building and inference threads."""

    def __init__(self, maxsize: int = 8):
        self._q: "queue.Queue[Optional[HashTable]]" = queue.Queue(maxsize=maxsize)

    def put(self, table: Optional[HashTable]) -> None:
        self._q.put(table)

    def get(self, timeout: Optional[float] = None) -> Optional[HashTable]:
        return self._q.get(timeout=timeout)

    def close(self) -> None:
        self._q.put(None)
