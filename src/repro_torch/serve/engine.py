"""Batched serving engine: prefill + decode with slot-based continuous
batching, the reference's ``serve/engine.py`` step for step.

No gradient is aggregated here, so the compression plays no role, and
no hand kernel runs: the model's serving functions are plain PyTorch,
run eagerly under ``torch.inference_mode()``.

``ServeEngine.generate`` is the simple batch API; ``ContinuousBatcher``
keeps a fixed pool of decode slots and admits queued requests as slots
free up (the vLLM-style loop, minus paging). Its semantics are the
reference's, kept on purpose:

- greedy ``argmax``, the first index on ties;
- one decode position shared by every slot: an admission sets it to
  ``max(pos, len(prompt))``, so a slot admitted later attends to the
  zero keys between its prompt's end and that position;
- decode writes past ``max_len`` land on the cache's last entry (the
  clamp of the reference's ``dynamic_update_slice``);
- a request is admitted between decode steps by a single-request
  prefill spliced into its slot, and ``decode_steps`` bounds the loop;
- the splice writes every leaf of the cache at ``[:, i:i+1]`` (axis 1),
  broadcasting as the reference's ``full.at[:, i:i+1].set(one)`` does.
  For the attention families and ssm, axis 1 is the slot. For hybrid,
  the Mamba leaves ``(n_super, attn_period - 1, B, ...)`` hold the
  position inside the superblock there: with ``attn_period`` 2 slot 0's
  admission broadcasts its Mamba state over every slot and later slots
  write none; with a longer period the shapes do not broadcast and the
  admission raises, as the reference's does;
- the single-request prefill passes the prompt's tokens alone, so on the
  encdec family, whose prefill needs ``frames``, the first admission
  raises ``KeyError``, as the reference's does (``generate`` takes the
  frames as ``extra``).
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.params import ParamTree, flatten_tree
from repro_torch.models.registry import ModelAPI


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]


class ServeEngine:
    """Greedy generation over ``api``'s model with ``params`` (a
    :class:`ParamTree`) on the params' device; caches of ``max_len``
    positions, ``batch`` decode slots for the batcher."""

    def __init__(self, api: ModelAPI, params: ParamTree, max_len: int,
                 batch: int):
        self.api = api
        self.tree = params.tree()
        self.device = self.tree["embed"].device
        self.max_len = max_len
        self.batch = batch

    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray,
                extra: Optional[Dict[str, Any]] = None):
        """(B, S) prompts (and ``extra`` batch entries, e.g. the encdec
        family's ``frames``, moved to the device as they are) -> (last
        logits (B, V), cache of ``max_len`` positions)."""
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
        batch = {"tokens": tokens.long()}
        if extra:
            batch.update({k: torch.as_tensor(np.asarray(v), device=self.device)
                          for k, v in extra.items()})
        return self.api.prefill(self.tree, batch, self.max_len)

    @torch.inference_mode()
    def decode(self, tok: torch.Tensor, cache, pos: int):
        """One step for every row at position ``pos`` -> (logits (B, V),
        cache); the cache is updated in place."""
        return self.api.decode(self.tree, tok, cache, pos)

    # -- simple batch generate ----------------------------------------

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, max_new: int,
                 extra: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """tokens: (B, S) prompts (same length); ``extra``: more batch
        entries for the prefill (the encdec family's ``frames``). Greedy
        decode -> (B, max_new) int32. The tokens stay on the device until
        the end, so the host does not wait on the device between steps."""
        S = tokens.shape[1]
        logits, cache = self.prefill(tokens, extra)
        out = []
        tok = logits.argmax(dim=-1)
        pos = S
        for _ in range(max_new):
            out.append(tok)
            logits, cache = self.decode(tok, cache, pos)
            tok = logits.argmax(dim=-1)
            pos += 1
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed decode batch.

    Each slot holds one in-flight request; finished slots are refilled
    from the queue between decode steps. The KV cache is allocated once
    at engine size and slots are overwritten on admission (prefill into
    slot i via a single-request prefill + cache splice).
    """

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.done: List[Completion] = []

    def submit(self, req: Request):
        self.queue.put(req)

    @torch.inference_mode()
    def run(self, decode_steps: int = 64) -> List[Completion]:
        eng = self.engine
        B = eng.batch
        slots: List[Optional[Request]] = [None] * B
        remaining = np.zeros(B, np.int32)
        produced: List[List[int]] = [[] for _ in range(B)]
        cache = eng.api.init_cache(eng.tree, B, eng.max_len)
        cur = torch.zeros(B, dtype=torch.long, device=eng.device)
        pos = 0

        def admit():
            nonlocal pos
            for i in range(B):
                if slots[i] is None and not self.queue.empty():
                    req = self.queue.get()
                    slots[i] = req
                    remaining[i] = req.max_new_tokens
                    produced[i] = []
                    # single-request prefill, spliced into slot i
                    logits, c1 = eng.prefill(req.prompt[None])
                    for (_, full), (_, one) in zip(flatten_tree(cache),
                                                   flatten_tree(c1)):
                        full[:, i:i + 1] = one.to(full.dtype)
                    cur[i] = logits[0].argmax()
                    pos = max(pos, int(req.prompt.shape[0]))

        admit()
        for _ in range(decode_steps):
            if all(s is None for s in slots):
                break
            logits, cache = eng.decode(cur, cache, pos)
            nxt = logits.argmax(dim=-1)
            pos += 1
            host = cur.cpu().numpy()
            for i in range(B):
                if slots[i] is not None:
                    produced[i].append(int(host[i]))
                    remaining[i] -= 1
                    if remaining[i] <= 0:
                        self.done.append(
                            Completion(uid=slots[i].uid, tokens=produced[i]))
                        slots[i] = None
            cur = nxt
            admit()
        return self.done
