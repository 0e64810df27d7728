"""Deterministic, resumable, shard-aware synthetic token pipeline: a numpy
copy of ``repro/data/tokens.py`` (the same batches, bit for bit, for the
same seed, step and shard).

  * **step-indexed determinism**: ``batch_at(step)`` is a pure function of
    (seed, step, shard), so a restart from a checkpoint resumes the exact
    token stream with no persisted iterator state, and resharding only
    changes the (shard, n_shards) arguments;
  * **shard awareness**: each data-parallel host pulls only its slice of
    the global batch;
  * **prefetch**: a background thread keeps ``depth`` batches ready so the
    host never blocks the device (``PrefetchLoader``);
  * **straggler mitigation**: ``SkipAheadLoader`` bounds how long a step
    may wait for a slow producer; on timeout it skips ahead to the next
    step index (bounded skips, recorded), trading a sliver of data for
    step cadence.

The synthetic distribution is a mixture of integer-sequence "documents"
(arithmetic ramps, periodic motifs, noisy copies) with enough structure
that a small LM's loss visibly drops.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class TokenStream:
    """Pure step-indexed batch source."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg

    def _doc(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """One synthetic document of n tokens."""
        v = self.cfg.vocab
        kind = rng.integers(0, 3)
        if kind == 0:     # arithmetic ramp with random stride
            start = rng.integers(0, v)
            stride = rng.integers(1, 7)
            return (start + stride * np.arange(n)) % v
        if kind == 1:     # periodic motif
            period = rng.integers(2, 9)
            motif = rng.integers(0, v, period)
            return np.tile(motif, n // period + 1)[:n]
        # noisy copy: token repeated with occasional jumps
        out = np.empty(n, np.int64)
        tok = rng.integers(0, v)
        for i in range(n):
            if rng.random() < 0.1:
                tok = rng.integers(0, v)
            out[i] = tok
        return out

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Shard-local batch for global ``step``: {tokens, targets}."""
        cfg = self.cfg
        B, S = cfg.shard_batch, cfg.seq_len
        tokens = np.empty((B, S + 1), np.int32)
        for b in range(B):
            # deterministic per (seed, step, global row)
            row = cfg.shard * B + b
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, row])
            )
            buf = []
            while sum(len(d) for d in buf) < S + 1:
                buf.append(self._doc(rng, int(rng.integers(16, S + 2))))
            tokens[b] = np.concatenate(buf)[: S + 1].astype(np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Background-thread prefetch of a step-indexed source."""

    def __init__(self, stream: TokenStream, *, depth: int = 2,
                 start_step: int = 0):
        self.stream = stream
        self.depth = depth
        self._q: "queue.Queue[tuple[int, Any]]" = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._next
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, Any]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class SkipAheadLoader:
    """Bounded-staleness wrapper: never wait more than ``timeout_s`` per step.

    If the underlying producer (possibly artificially slowed — see
    ``delay_fn`` used by the straggler tests) misses the deadline, the step
    index advances anyway and the late batch is discarded on arrival.
    ``skipped`` records the step ids sacrificed to keep cadence; the cap
    ``max_consecutive_skips`` turns a persistent stall into a hard error
    instead of silently training on nothing.
    """

    def __init__(self, stream: TokenStream, *, timeout_s: float = 1.0,
                 max_consecutive_skips: int = 3,
                 delay_fn=None, start_step: int = 0):
        self.stream = stream
        self.timeout_s = timeout_s
        self.max_skips = max_consecutive_skips
        self.delay_fn = delay_fn
        self.step = start_step
        self.skipped: list[int] = []
        self._consecutive = 0

    def _produce(self, step: int, out: dict):
        if self.delay_fn is not None:
            time.sleep(self.delay_fn(step))
        out["batch"] = self.stream.batch_at(step)

    def get(self) -> tuple[int, Any]:
        while True:
            out: dict = {}
            t = threading.Thread(
                target=self._produce, args=(self.step, out), daemon=True
            )
            t.start()
            t.join(self.timeout_s)
            if "batch" in out:
                step = self.step
                self.step += 1
                self._consecutive = 0
                return step, out["batch"]
            # straggler: skip this step, bounded
            self.skipped.append(self.step)
            self._consecutive += 1
            if self._consecutive > self.max_skips:
                raise RuntimeError(
                    f"data pipeline stalled: {self._consecutive} consecutive "
                    f"skips at step {self.step}"
                )
            self.step += 1
