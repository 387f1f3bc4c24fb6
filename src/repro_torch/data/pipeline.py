"""Deterministic synthetic data pipeline with background prefetch.

Every batch is a pure numpy function of ``(seed, step)``, the
reference's own construction, so the port and the reference train on the
same tokens, and a restart replays the exact token stream without any
persisted iterator state.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def batch_fn(cfg: ModelConfig, global_batch: int, seq_len: int,
             seed: int = 0) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns step -> host batch dict (tokens, labels: int32 (B, S))."""

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, 0xDA7A]))
        toks = rng.integers(0, cfg.vocab, (global_batch, seq_len + 1),
                            dtype=np.int32)
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make


class Prefetcher:
    """Background-thread prefetch of ``(step, batch)`` items from
    ``start_step`` on, at most ``depth`` ahead: the reference's class,
    with ``device`` in place of its shardings.

    With ``device`` set, the thread turns each host batch into int64
    tensors (pinned where ``device`` is a card) and :meth:`__next__`
    moves them there (``non_blocking``: the copy queues on the current
    stream); without it the items are the host batches themselves."""

    def __init__(self, make_batch: Callable[[int], Dict[str, np.ndarray]],
                 device=None, depth: int = 2, start_step: int = 0):
        self._make = make_batch
        self._device = None if device is None else torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _host(self, batch: Dict[str, np.ndarray]):
        if self._device is None:
            return batch
        pin = self._device.type == "cuda"
        return {k: torch.from_numpy(v).to(torch.int64).pin_memory() if pin
                else torch.from_numpy(v).to(torch.int64)
                for k, v in batch.items()}

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            item = (step, self._host(self._make(step)))
            while True:
                try:
                    self._q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self._device is not None:
            batch = {k: v.to(self._device, non_blocking=True)
                     for k, v in batch.items()}
        return step, batch

    def close(self):
        """Stop the thread: the queue drained, it ends within a second."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
