"""Deterministic synthetic data pipeline with background prefetch.

Every batch is a pure numpy function of ``(seed, step)``, the
reference's own construction, so the port and the reference train on the
same tokens (and the same ``frames`` or ``vis_embed`` bytes), and
a restart replays the exact stream without any persisted iterator
state.
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
    """Returns step -> host batch dict: tokens, labels int32 (B, S); for
    the encdec family also ``frames`` f32 (B, enc_seq, D), the stub audio
    frontend's frame embeddings, and for the vlm family ``vis_embed`` f32
    (B, vis_tokens, D), the stub vision frontend's patch embeddings, each
    drawn from the same generator after the tokens."""

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, 0xDA7A]))
        toks = rng.integers(0, cfg.vocab, (global_batch, seq_len + 1),
                            dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                0, 1, (global_batch, cfg.enc_seq, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "vlm":
            batch["vis_embed"] = rng.normal(
                0, 1, (global_batch, cfg.vis_tokens, cfg.d_model)
            ).astype(np.float32)
        return batch

    return make


def host_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy batch -> CPU tensors: integer arrays (tokens, labels) as
    int64, float arrays (``frames``, ``vis_embed``) in their own dtype."""
    return {k: torch.from_numpy(v).to(torch.int64)
            if np.issubdtype(v.dtype, np.integer) else torch.from_numpy(v)
            for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of ``(step, batch)`` items from
    ``start_step`` on, at most ``depth`` ahead: the reference's class,
    with ``device`` in place of its shardings.

    With ``device`` set, the thread turns each host batch into tensors
    (:func:`host_tensors`: integer arrays as int64, float arrays as
    they are; pinned where ``device`` is a card) and :meth:`__next__`
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
        host = host_tensors(batch)
        if self._device.type == "cuda":
            host = {k: v.pin_memory() for k, v in host.items()}
        return host

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
