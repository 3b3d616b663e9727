"""Fault-tolerant checkpointing (counterpart of
``repro.checkpoint.checkpointer``), in the reference's on-disk format:

  * ``step_%08d/`` holds ``host{id}.npz`` (this host's arrays, keyed by
    their "/"-joined tree paths) and ``manifest.json`` (``step``,
    ``n_hosts``, and per array ``shape``, ``dtype``, ``crc32`` and
    ``host``);
  * writes are atomic: a ``.tmp-{step}-{host}`` directory renamed into
    place, so a killed writer never leaves a partial checkpoint that
    counts;
  * every array's crc32 is checked on restore, with the missing key and
    the shape;
  * async: ``save()`` copies every tensor to the host before it returns
    (the next step updates the parameters in place, so a copy that ran
    later would race with it), and the file I/O runs on a thread;
  * retention: the ``keep`` newest checkpoints are kept.

A checkpoint written by either package restores in the other for the
same key paths.  A bf16 tensor is stored as its raw 16-bit words (numpy
void ``|V2``, what numpy writes for the reference's ``ml_dtypes``
bfloat16) under dtype ``"bfloat16"``, so no numpy bfloat16 dtype is
needed; the crc32 covers the same bytes.  The reference's elastic
``shardings=`` restore waits for the port's device mesh (ROADMAP A13.7).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.optim import tree as T

_MANIFEST = "manifest.json"


def _host_array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A copy of ``t`` on the host as numpy (bf16 as raw words), and its
    dtype's name in the manifest."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 host_id: int = 0, n_hosts: int = 1):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Checkpoint ``tree`` (nested dicts / lists of tensors) at
        ``step``.  The host copies are made now; the file I/O runs on a
        background thread unless ``blocking``."""
        self.wait()
        arrays, dtypes = {}, {}
        for path, leaf in T.flatten(tree).items():
            arrays[T.key(path)], dtypes[T.key(path)] = _host_array(
                torch.as_tensor(leaf))

        def write() -> None:
            tmp = self.dir / f".tmp-{step}-{self.host_id}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "n_hosts": self.n_hosts,
                        "arrays": {}}
            np.savez(tmp / f"host{self.host_id}.npz", **arrays)
            for k, arr in arrays.items():
                manifest["arrays"][k] = {
                    "shape": list(arr.shape),
                    "dtype": dtypes[k],
                    "crc32": zlib.crc32(np.ascontiguousarray(arr)
                                        .tobytes()),
                    "host": self.host_id,
                }
            (tmp / _MANIFEST).write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)           # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if (p / _MANIFEST).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None, like, device=None):
        """Restore into the structure of ``like`` (nested dicts / lists of
        tensors, meta tensors included): each array checked against its
        crc32 and ``like``'s shape, cast to ``like``'s dtype, on
        ``device`` (default: each leaf's own device; a meta leaf's on the
        CPU).  Returns (step, tree)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / _MANIFEST).read_text())
        data = np.load(cdir / f"host{self.host_id}.npz")
        out = {}
        for path, leaf in T.flatten(like).items():
            k = T.key(path)
            if k not in manifest["arrays"]:
                raise KeyError(f"checkpoint missing array {k}")
            arr = data[k]
            meta = manifest["arrays"][k]
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                    != meta["crc32"]:
                raise IOError(f"checksum mismatch for {k} "
                              f"(corrupt checkpoint {cdir})")
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{k}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            dev = device if device is not None else (
                "cpu" if leaf.is_meta else leaf.device)
            out[path] = _tensor(arr, meta["dtype"]).to(device=dev,
                                                       dtype=leaf.dtype)
        return step, T.from_flat(like, out)
