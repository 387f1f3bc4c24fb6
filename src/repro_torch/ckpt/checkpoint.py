"""Checkpointing: atomic, content-hashed, layout-free, async-capable.

The reference's on-disk format (``repro/ckpt/checkpoint.py``), so each
side reads what the other writes:

    <dir>/step_000123/
        manifest.json   — step, user metadata, and for each leaf its
                          path, file, shape, dtype and sha256
        leaf_00000.bin  — raw little-endian bytes (bf16 too)

Writes go to ``step_X.tmp`` and are renamed atomically, so a crash never
leaves a half-written checkpoint that restore would pick up. A state is a
pytree of tensors flattened as ``jax.tree.flatten`` flattens the
reference's: dict keys sorted, list and tuple items in order, dataclass
fields in declaration order (``register_dataclass``), paths joined with
``.``. A restore, which the run waits for, reads and hashes up to eight
leaves at once; a save writes one leaf at a time, since it overlaps
training (writing on every core slowed the step it overlapped on the
H100's host from ~300 ms to 1.8 s). The bytes go through torch (a
tensor's ``uint8`` view), since bf16 has no numpy dtype here; the dtype
names are numpy's, as the reference writes them, mapped to torch dtypes
explicitly (:data:`DTYPES`).

Restore copies every leaf into the caller's tensors in place
(``template``): the tensors keep their devices, as the reference's
``shardings`` place its leaves, and anything that holds a reference to
them keeps it.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_READ_THREADS = 8  # leaves read and hashed at once by a restore: hashlib
                   # and file I/O release the interpreter lock

# numpy's dtype names, as the reference's manifests carry them
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in ``jax.tree.flatten`` order (see the module
    docstring); a leaf is anything that is not a dict, list, tuple or
    dataclass instance."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten(v, join(i))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in flatten(getattr(tree, f.name), join(f.name))]
    return [(prefix, tree)]


def _host(leaf) -> torch.Tensor:
    """A CPU copy of ``leaf`` (a tensor, numpy array or scalar) that later
    in-place updates of ``leaf`` do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf, copy=True))


def _host_copy(state: Any) -> List[Tuple[str, torch.Tensor]]:
    """``[(path, CPU copy)]`` of ``state``'s leaves."""
    return [(p, _host(v)) for p, v in flatten(state)]


def _raw(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes as a flat uint8 array (no copy where ``t`` is
    contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _write(directory: str, step: int, leaves: List[Tuple[str, torch.Tensor]],
           metadata: Optional[Dict], keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": []}
    for i, (p, t) in enumerate(leaves):
        if t.dtype not in _NAMES:
            raise TypeError(f"leaf {p}: no checkpoint dtype for {t.dtype}")
        fname = f"leaf_{i:05d}.bin"
        raw = _raw(t)
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
        manifest["leaves"].append({
            "path": p, "file": fname, "shape": list(t.shape),
            "dtype": _NAMES[t.dtype], "sha256": hashlib.sha256(raw).hexdigest(),
        })
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep_last)
    return final


def save(directory: str, step: int, state: Any,
         metadata: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    return _write(directory, step, _host_copy(state), metadata, keep_last)


class AsyncCheckpointer:
    """Overlaps checkpoint writing with training (one writer thread, so
    checkpoints land in order).

    :meth:`save` copies the state to the host before it returns: the
    train step updates its tensors in place. Only hashing and writing
    the files run in the background. ``records`` holds one dict a save:
    its ``step``, ``bytes``, the blocking host copy's ``copy_ms`` and,
    once written, the background ``write_ms``."""

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._last: Optional[cf.Future] = None
        self.records: List[Dict[str, float]] = []

    def save(self, directory: str, step: int, state: Any,
             metadata: Optional[Dict] = None, keep_last: int = 3) -> cf.Future:
        t0 = time.perf_counter()
        leaves = _host_copy(state)
        rec = {"step": step,
               "bytes": sum(t.numel() * t.element_size() for _, t in leaves),
               "copy_ms": (time.perf_counter() - t0) * 1e3}
        self.records.append(rec)

        def write():
            t1 = time.perf_counter()
            out = _write(directory, step, leaves, metadata, keep_last)
            rec["write_ms"] = (time.perf_counter() - t1) * 1e3
            return out

        self._last = self._pool.submit(write)
        return self._last

    def wait(self):
        if self._last is not None:
            self._last.result()

    def close(self):
        """Finish the pending write and stop the writer thread."""
        self.wait()
        self._pool.shutdown()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _read_leaf(path: str, entry: Dict, verify: bool) -> torch.Tensor:
    fname = os.path.join(path, entry["file"])
    buf = torch.empty(os.path.getsize(fname), dtype=torch.uint8)
    with open(fname, "rb") as f:
        f.readinto(buf.numpy())
    if verify and hashlib.sha256(buf.numpy()).hexdigest() != entry["sha256"]:
        raise IOError(f"checksum mismatch in {entry['file']} "
                      f"(corrupt checkpoint {path})")
    if entry["dtype"] not in DTYPES:
        raise TypeError(f"leaf {entry['path']}: unknown dtype {entry['dtype']!r}")
    return buf.view(DTYPES[entry["dtype"]]).reshape(entry["shape"])


def restore(directory: str, step: Optional[int] = None, template: Any = None,
            verify: bool = True) -> Any:
    """Read a checkpoint (default: the latest). Without ``template``:
    ``(manifest, leaves)``, the leaves CPU tensors in manifest order.
    With ``template`` (a pytree of tensors with the checkpoint's paths,
    shapes and dtypes): each leaf copied into the template's tensor in
    place, and the template returned. A leaf whose bytes do not hash to
    the manifest's sha256 raises ``IOError`` (unless ``verify`` is off)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    def read():
        # the first exception of a leaf is raised when its result is read
        with cf.ThreadPoolExecutor(max_workers=_READ_THREADS) as pool:
            return list(pool.map(lambda e: _read_leaf(path, e, verify),
                                 manifest["leaves"]))

    if template is None:
        return manifest, read()
    dst = flatten(template)
    want = [(e["path"], tuple(e["shape"]), DTYPES.get(e["dtype"]))
            for e in manifest["leaves"]]
    have = [(p, tuple(t.shape), t.dtype) for p, t in dst]
    if have != want:
        i = next((i for i, (h, w) in enumerate(zip(have, want)) if h != w),
                 min(len(have), len(want)))
        raise ValueError(
            f"template does not match checkpoint {path} at leaf {i}: "
            f"{have[i] if i < len(have) else None} against "
            f"{want[i] if i < len(want) else None}")
    with torch.no_grad():
        for (_, t), x in zip(dst, read()):
            t.copy_(x)
    return template


def _gc(directory: str, keep_last: int):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
