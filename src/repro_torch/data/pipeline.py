"""Deterministic, sharded, checkpointable synthetic LM data pipeline, a
copy of :mod:`repro.data.pipeline` (numpy only): its batches equal the
JAX package's bit for bit for every (seed, step, shard).

Design constraints it satisfies (1000-node posture):

* **Determinism**: batch content is a pure function of (seed, step,
  shard) — any worker can reproduce any batch, so restarts and elastic
  re-sharding never replay or skip data.
* **Sharding**: each data-parallel rank draws only its slice; re-sharding
  to a different rank count re-partitions the same global stream.
* **Checkpointability**: pipeline state is just the step counter —
  persisted with the model checkpoint and restored exactly.
* **Prefetch**: a background thread keeps ``prefetch`` batches ready so
  host data work overlaps device steps.

The token stream is a mixture of zipf-distributed unigrams and repeated
n-gram motifs (so models have actual structure to learn in the examples —
loss decreases measurably, unlike uniform noise).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    zipf_alpha: float = 1.1
    motif_len: int = 8
    n_motifs: int = 64


class DataPipeline:
    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.cfg = cfg
        self.step = 0
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        rng = np.random.default_rng(cfg.seed)
        # fixed motif table (deterministic across workers)
        self._motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len))
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_alpha
        self._p = p / p.sum()

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        """The globally-agreed batch for ``step``, sliced to this shard."""
        cfg = self.cfg
        per_shard = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard))
        toks = rng.choice(cfg.vocab, size=(per_shard, cfg.seq_len),
                          p=self._p)
        # stamp motifs: learnable repeated structure
        n_stamps = cfg.seq_len // (cfg.motif_len * 4)
        for b in range(per_shard):
            ids = rng.integers(0, cfg.n_motifs, size=n_stamps)
            pos = rng.integers(0, cfg.seq_len - cfg.motif_len,
                               size=n_stamps)
            for m, p0 in zip(ids, pos):
                toks[b, p0:p0 + cfg.motif_len] = self._motifs[m]
        return {"tokens": toks.astype(np.int32)}

    # ------------------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    # ------------------------------------------------------------------
    def start_prefetch(self) -> None:
        def worker():
            step = self.step
            while not self._stop.is_set():
                try:
                    self._queue.put((step, self.batch_at(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> dict:
        step, batch = self._queue.get()
        self.step = step + 1
        return batch

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

    def reshard(self, n_shards: int, shard: int) -> "DataPipeline":
        """Elastic re-sharding: same stream, new partition."""
        cfg = dataclasses.replace(self.cfg, n_shards=n_shards, shard=shard)
        p = DataPipeline(cfg)
        p.step = self.step
        return p
