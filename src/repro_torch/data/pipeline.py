"""Deterministic synthetic token pipeline (a copy of the reference's
`data/pipeline.py`, numpy only, plus `to_device`).

Stateless-per-step generation: batch(step) is a pure function of
(seed, step, shard), so a restarted or rescaled job replays the exact
stream from any step: no iterator state to checkpoint, no skipped or
duplicated batches after preemption or failure.  `batch_at` returns the
reference's bits.

The synthetic "corpus" has Zipf-distributed unigrams and a first-order
repetition structure (tokens repeat with probability `rep_p`), which gives
training runs a learnable signal (loss drops from ln(V) toward the entropy
of the repetition process).

`shards`/`shard_id` implement host-sharded loading: each data-parallel host
generates only its slice of the global batch.  A background prefetch thread
overlaps generation with the device's step.
"""
from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    rep_p: float = 0.5
    shards: int = 1
    shard_id: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {cfg.shards} shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.shards
        # zipf marginal over the vocab, truncated + normalised
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """{tokens, labels} i32[local_batch, seq_len]; pure in (seed, step)."""
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=[cfg.seed * 0x9E3779B9 + step, cfg.shard_id]))
        b, s = self.local_batch, cfg.seq_len
        fresh = rng.choice(cfg.vocab, size=(b, s + 1), p=self._probs)
        repeat = rng.random((b, s + 1)) < cfg.rep_p
        toks = fresh.copy()
        for t in range(1, s + 1):       # first-order repetition structure
            toks[:, t] = np.where(repeat[:, t], toks[:, t - 1], fresh[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterator(self, start_step: int = 0, prefetch: int = 2):
        """Prefetching iterator of (step, batch) from start_step."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch_at(step)))
                step += 1

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def to_device(batch: dict, device="cuda") -> dict:
    """A numpy batch as int64 tensors on `device` (the index type that
    PyTorch's gathers take)."""
    return {k: torch.as_tensor(v, dtype=torch.int64, device=device)
            for k, v in batch.items()}


def entropy_floor(cfg: DataConfig) -> float:
    """Cross-entropy of the generating process (the loss a perfect model
    reaches), used by examples to show how close training got."""
    p_rep = cfg.rep_p
    # fresh-token entropy under the zipf marginal
    probs = np.arange(1, cfg.vocab + 1, dtype=np.float64) ** (-cfg.zipf_a)
    probs /= probs.sum()
    h_zipf = -float(np.sum(probs * np.log(probs)))
    # mixture: with prob rep_p the next token is a copy (entropy ~ H(rep_p)),
    # else fresh.  Lower bound (model knows the previous token):
    hb = -(p_rep * math.log(p_rep + 1e-12)
           + (1 - p_rep) * math.log(1 - p_rep + 1e-12))
    return hb + (1 - p_rep) * h_zipf
