"""Atomic, async, globally addressed checkpointing (the port of
``repro.checkpoint.checkpoint``, in its on-disk format).

Each leaf is stored as the full global tensor plus its tree path, so a
checkpoint restores into any trainer whose state has the same paths --
one of another kernel count included (elastic restart) -- and a
checkpoint the JAX package wrote for a float32 trainer restores into the
port's.  Layout per step::

    <dir>/step_00000042/
        manifest.json        # step, extras, per leaf: path, file, shape,
                             # dtype, sha256
        leaf_00000.npy ...   # one file per leaf, in pytree order

Writes go to ``step_X.tmp`` and are renamed into place, so a crash mid
save never leaves a partial checkpoint that ``all_steps`` lists;
``keep`` bounds how many steps stay.  ``save_async`` snapshots the
tensors to the host at once (training may go on and overwrite nothing
of it) and writes on a background thread.

numpy has no bfloat16 (the JAX package writes one through
``ml_dtypes``, which the port does not use): a bfloat16 leaf is stored
as its raw 16 bits, a ``uint16`` array, under ``"dtype": "bfloat16"``
in the manifest, and restored bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten

BF16 = "bfloat16"


class ChecksumError(IOError):
    """A restored leaf file failed its manifest sha256 (bit rot, torn
    write, or a transport fault on shared storage).  Carries enough to
    act on: which file, what the manifest promised, what the bytes
    hashed to."""

    def __init__(self, path: str, file: str, expected: str, actual: str):
        self.path = path
        self.file = file
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"checksum mismatch for leaf {path!r} ({file}): manifest "
            f"sha256 {expected}, file hashed {actual} — the checkpoint "
            "file is corrupt (re-read once already; restore from an "
            "earlier step or re-replicate the file)")


def _read_verified(d: str, entry: dict, name: str) -> np.ndarray:
    """Load one leaf file, verifying its manifest sha256.  A mismatch is
    re-read once before failing: a concurrent replicator or page-cache
    race can give one torn read on shared storage, but a second
    mismatch means the bytes really are wrong."""
    path = os.path.join(d, entry["file"])
    actual = None
    for _attempt in range(2):
        with open(path, "rb") as f:
            actual = hashlib.sha256(f.read()).hexdigest()
        if actual == entry["sha256"]:
            return np.load(path)
    raise ChecksumError(name, entry["file"], entry["sha256"], actual)


def _to_host(x):
    """A leaf as the numpy array its file holds (bfloat16: the bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), BF16
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    return x, str(x.dtype)


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == BF16:
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr)
    if dtype == BF16:
        t = t.view(torch.bfloat16)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    @staticmethod
    def _snapshot(tree):
        return [(name, *_to_host(leaf)) for name, leaf in tree_paths(tree)]

    def save(self, step: int, tree, extras: dict | None = None):
        self._write(step, self._snapshot(tree), extras or {})

    def save_async(self, step: int, tree, extras: dict | None = None):
        """Snapshot to host now; write in the background."""
        self.wait()
        host = self._snapshot(tree)
        t = threading.Thread(target=self._write,
                             args=(step, host, extras or {}))
        t.start()
        self._pending = t

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host, extras: dict):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extras": extras, "leaves": []}
        for i, (name, leaf, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), leaf)
            with open(os.path.join(tmp, fname), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["leaves"].append({
                "path": name, "file": fname, "shape": list(leaf.shape),
                "dtype": dtype, "sha256": digest,
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None, verify: bool = False):
        """Restore into the structure of ``like``, leaf by tree path,
        each leaf on the device of ``like``'s leaf (so a trainer of
        another kernel count, or on another device, restores the same
        files).  Returns ``(tree, extras)``; a leaf whose stored shape
        differs from ``like``'s raises."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for name, leaf in tree_paths(like):
            entry = by_path[name]
            if verify:
                arr = _read_verified(d, entry, name)
            else:
                arr = np.load(os.path.join(d, entry["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {name!r} has shape "
                                 f"{tuple(arr.shape)}, the state restored "
                                 f"into has {tuple(leaf.shape)}")
            out.append(_from_host(arr, entry["dtype"], leaf))
        return tree_unflatten(like, out), manifest["extras"]
