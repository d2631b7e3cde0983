"""Synthetic shard-aware data pipeline with background prefetch.

Counterpart of ``repro/data/pipeline.py``.  Batches are drawn with numpy,
exactly as the reference draws them, so both packages see the same tokens
for the same (seed, step); the prefetcher moves them to a torch device.

Deterministic synthetic token streams (seeded per shard) stand in for a
tokenized corpus: each *data shard* (one per DP rank group) draws from its own
PRNG stream, so global batches are reproducible under any DP layout and across
restarts (the stream is indexed by step, not by wall clock).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # frontend stubs
    enc_len: int = 0
    d_model: int = 0
    n_img_tokens: int = 0
    family: str = "dense"


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Deterministic batch for a global step (host numpy; restart-safe)."""
    rng = np.random.default_rng((cfg.seed, step))
    toks = rng.integers(0, cfg.vocab_size, (cfg.global_batch, cfg.seq_len + 1), dtype=np.int64)
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
    if cfg.family == "audio":
        batch["enc_frames"] = rng.normal(
            size=(cfg.global_batch, cfg.enc_len, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.normal(
            size=(cfg.global_batch, cfg.n_img_tokens, cfg.d_model)
        ).astype(np.float32)
    return batch


class Prefetcher:
    """Background thread that keeps ``depth`` batches ready (as tensors on
    ``device`` when one is given) so the train loop never waits on the host."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2, device=None):
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_at(self.cfg, step)
            if self.device is not None:
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def data_config_for(arch, shape, seed: int = 0) -> DataConfig:
    return DataConfig(
        vocab_size=arch.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        enc_len=arch.enc_len_train,
        d_model=arch.d_model,
        n_img_tokens=arch.n_img_tokens,
        family=arch.family,
    )
