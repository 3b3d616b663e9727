"""Deterministic synthetic data pipeline, host-sliced and prefetching
(counterpart of ``repro.data.pipeline``; numpy only, so a batch equals the
reference's bit for bit).

  * a batch is a pure function of (seed, step, host): a restarted host
    resumes mid-epoch at the exact batch, which makes checkpoint/restart
    exact;
  * each host makes only its rows of the global batch
    (``host_id`` / ``n_hosts``);
  * a background thread makes batch ``step + 1`` while ``step`` is used.

Each row is drawn by numpy's ``default_rng((seed, step, global_row))``.
Tokens repeat the previous token with probability 1/2, a learnable
bigram structure, so cross-entropy falls under training; the frames
variant adds stub frame embeddings for an encoder.
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
    host_id: int = 0
    n_hosts: int = 1
    frames_dim: int = 0        # >0: also emit [b, s, dim] frame embeddings

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """This host's rows of the global batch at ``step``: ``tokens`` and
    next-token ``labels`` [host_batch, seq_len] int32 (and ``frames``
    [host_batch, seq_len, frames_dim] f32 when ``frames_dim``)."""
    rows, labels = [], []
    n = cfg.seq_len + 1
    for r in range(cfg.host_batch):
        global_row = cfg.host_id * cfg.host_batch + r
        rng = np.random.default_rng((cfg.seed, step, global_row))
        stream = rng.integers(1, cfg.vocab, size=n, dtype=np.int32)
        # repeat the previous token with probability 1/2: each position
        # takes the token of the last freshly drawn index
        fresh = rng.random(n) >= 0.5
        fresh[0] = True
        src = np.maximum.accumulate(np.where(fresh, np.arange(n), 0))
        stream = stream[src]
        rows.append(stream[:-1])
        labels.append(stream[1:])
    out = {"tokens": np.stack(rows), "labels": np.stack(labels)}
    if cfg.frames_dim:
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id, 7))
        out["frames"] = rng.standard_normal(
            (cfg.host_batch, cfg.seq_len, cfg.frames_dim)
        ).astype(np.float32)
    return out


class Prefetcher:
    """Background-thread double buffering over ``batch_at``: ``next``
    gives ``(step, batch)`` from ``start_step`` on, in order."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = batch_at(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
