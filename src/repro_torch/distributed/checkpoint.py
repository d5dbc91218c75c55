"""Fault-tolerant checkpointing.

Port of ``repro.distributed.checkpoint``, the same files on disk:

    <dir>/step_<N>/
           manifest.json            step, leaf names, shapes, dtypes
           host<k>.npz              this host's arrays
    <dir>/LATEST                    atomic pointer (written last)

A leaf's name is its path in the reference's order (``training.tree``:
dict keys sorted, sequence indices), joined by '/', as the reference's
``_flatten`` names it; so a checkpoint written by either package
restores in the other, bit for bit.

Guarantees:
  * atomic: data is written to step_<N>.tmp/ then renamed; LATEST is updated
    only after the rename, so a crash mid-write never corrupts a restore.
  * async: ``AsyncCheckpointer.save`` copies the tensors to host memory
    synchronously and does the file I/O on a background thread; ``wait()``
    raises the error of a save that failed.
  * restore by name: each array is checked against the shape of its leaf
    in ``tree_like`` and placed on the device asked for.
  * keep-last-k garbage collection.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.models.model import resolve_device
from repro_torch.training import tree as T


def _flatten(tree) -> dict:
    """{name: leaf} in the reference's order."""
    return {"/".join(str(p) for p in path): leaf
            for path, leaf in T.flatten_with_path(tree)}


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(tree, directory: str, step: int, host_id: int = 0,
         keep: int = 3) -> str:
    """Synchronous checkpoint save (host 0 writes the manifest)."""
    flat = _flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(os.path.join(tmp, f"host{host_id}.npz"), **arrays)
    if host_id == 0:
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                     for k, a in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _placements(tree_like, shardings) -> list:
    """One device per leaf of ``tree_like``: ``shardings`` is one device
    (or None: the card) or a tree of devices of ``tree_like``'s
    structure."""
    n = len(T.leaves(tree_like))
    if shardings is None or isinstance(shardings, (str, torch.device)):
        return [resolve_device(shardings, "checkpoint.restore")] * n
    return [resolve_device(d, "checkpoint.restore")
            for d in T.leaves_up_to(tree_like, shardings)]


def restore(tree_like, directory: str, step: int | None = None,
            shardings=None, host_id: int = 0):
    """Restore by name onto ``tree_like``'s structure, each leaf as a
    tensor on its device of ``shardings`` (the reference's
    ``device_put``): one ``torch.device`` for all, a tree of them, or
    None for the card (raises without CUDA). Returns (tree, step)."""
    devices = _placements(tree_like, shardings)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    data = np.load(os.path.join(d, f"host{host_id}.npz"))
    flat = _flatten(tree_like)
    leaves = []
    for (key, like), dev in zip(flat.items(), devices):
        arr = data[key]
        assert tuple(arr.shape) == tuple(like.shape), (
            f"shape mismatch for {key}: ckpt {arr.shape} vs {like.shape}")
        leaves.append(torch.from_numpy(arr).to(dev))
    return T.unflatten(tree_like, leaves), step


class AsyncCheckpointer:
    """Non-blocking saves: snapshot to host, write on a worker thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._pending: Future | None = None

    def save(self, tree, step: int, host_id: int = 0):
        self.wait()
        # snapshot device -> host now; I/O later
        host_tree = T.tree_map(_to_numpy, tree)
        self._pending = self._pool.submit(save, host_tree, self.directory,
                                          step, host_id, self.keep)

    def wait(self):
        """Block until the last save is on disk; raise its error if it
        failed (once)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()
