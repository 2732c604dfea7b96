"""Deterministic synthetic token pipeline, shard-aware (the port's own
copy of `repro.data.pipeline`, which needs numpy only; batches are equal
to the JAX package's bit for bit).

Real deployments stream tokenized corpora; here the substrate is a
deterministic generator with LEARNABLE structure (an order-2 mixture chain)
so end-to-end training demonstrably reduces loss, while staying fully
reproducible across restarts and reshards:

  * batch `i` is a pure function of (seed, step, global example index) --
    restart-safe: resuming at step k regenerates exactly the batches k, k+1..
  * each data shard generates ONLY its slice (no host broadcasting).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # learnable-structure knobs
    n_patterns: int = 64
    pattern_len: int = 32


class SyntheticLM:
    """Order-2 deterministic pattern corpus: each sequence stitches
    pseudo-random spans from a fixed pattern bank, so a model can reduce loss
    by memorizing bank statistics; tokens/labels are next-token shifted."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        self.bank = rng.randint(
            0, cfg.vocab_size,
            size=(cfg.n_patterns, cfg.pattern_len)).astype(np.int32)

    def example(self, index: int) -> np.ndarray:
        """Deterministic example by global index."""
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + index) % 2**31)
        n_spans = cfg.seq_len // cfg.pattern_len + 2
        pats = rng.randint(0, cfg.n_patterns, size=n_spans)
        seq = np.concatenate([self.bank[p] for p in pats])[: cfg.seq_len + 1]
        return seq

    def batch(self, step: int, shard_index: int = 0,
              num_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        local = cfg.global_batch // num_shards
        base = step * cfg.global_batch + shard_index * local
        seqs = np.stack([self.example(base + i) for i in range(local)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PrefetchIterator:
    """Single-slot lookahead prefetch (thread) -- overlaps host batch
    synthesis with device step execution."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        import threading
        import queue
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=2)
        self.step = start_step
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._stop = False

        def worker():
            s = start_step
            while not self._stop:
                try:
                    self.q.put(ds.batch(s, shard_index, num_shards),
                               timeout=0.5)
                    s += 1
                except Exception:
                    continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop = True
