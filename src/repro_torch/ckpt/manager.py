"""Checkpoints with atomic publish, bounded retention and async save
(counterpart of ``repro/ckpt/manager.py``, in its format).

* ``save``: copies each leaf to the host (per-leaf ``.npy``), writes a
  manifest with the step, the caller's ``extra`` and each leaf's shape,
  dtype and byte size, then renames ``step_N.tmp`` -> ``step_N`` (a crash
  mid-save never corrupts the latest checkpoint).  ``blocking=False`` does
  the file writes in a worker thread; the host copy is taken before
  ``save`` returns, so the caller may update its tensors in place at once.
* ``restore``: reads the manifest, checks each leaf's byte size and shape,
  and places it on the given device (the reference's ``shardings``; the
  mesh resharding waits for ROADMAP.md, queue 1, item 10).
* ``keep``: the oldest checkpoints pruned after a successful save.

Leaf files are named by the leaf's path in the reference's order (dict keys
sorted, list indices), joined by ``__``, so an f32 checkpoint moves between
the two packages.  bf16 leaves are stored as their 2-byte words (uint16)
with ``"dtype": "bfloat16"`` in the manifest: numpy has no bf16 of its own,
and the port does not need ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import flatten_with_path

__all__ = ["CheckpointManager"]

_SEP = "__"


def _flatten(tree) -> dict:
    return {_SEP.join(str(p) for p in path): leaf
            for path, leaf in flatten_with_path(tree)}


def _to_host(leaf):
    """(numpy copy, manifest dtype) of a leaf."""
    if not torch.is_tensor(leaf):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_host(arr, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, *, extra: dict | None = None,
             blocking: bool = True):
        """state: a tree of tensors.  extra: JSON-serializable metadata."""
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        self.wait()                       # one in-flight async save at a time
        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, extra: dict):
        tmp = os.path.join(self.directory, f"step_{step}.tmp")
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "leaves": {}}
        for k, (arr, dtype) in host.items():
            np.save(os.path.join(tmp, k + ".npy"), arr)
            manifest["leaves"][k] = {"shape": list(arr.shape),
                                     "dtype": dtype,
                                     "nbytes": int(arr.nbytes)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic publish
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"))

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, *, step: int | None = None,
                shardings=None) -> tuple:
        """Restore into the structure of ``state_like`` (a tree of tensors
        or of anything with a ``shape``).  ``shardings``: the device to
        place every leaf on; None puts each on its ``state_like`` leaf's
        device (the CPU for a leaf that has none).  Returns (state, step,
        extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for k, like in _flatten(state_like).items():
            meta = manifest["leaves"][k]
            arr = np.load(os.path.join(path, k + ".npy"))
            if arr.nbytes != meta["nbytes"]:
                raise IOError(f"checkpoint leaf {k} corrupt: "
                              f"{arr.nbytes} != {meta['nbytes']}")
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"leaf {k}: shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            device = shardings if shardings is not None else getattr(
                like, "device", "cpu")
            flat[k] = _from_host(arr, meta["dtype"]).to(device)
        return _rebuild(state_like, flat), step, manifest.get("extra", {})


def _rebuild(like, flat, path=()):
    """``like``'s structure with each leaf taken from ``flat`` by its
    key."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, path + (i,))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return flat[_SEP.join(str(p) for p in path)]
