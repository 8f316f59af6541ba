"""Checkpoint manager: atomic, asynchronous save and restore.  Port of
``repro/checkpoint/manager.py`` with its on-disk layout, so a checkpoint
written by either package reads in the other.

Layout: <dir>/step_<N>/ with one .npy per leaf of the saved tree (nested
dicts, lists and tuples of torch tensors or numpy arrays; dict keys in
sorted order, as JAX flattens them), named by its path joined with
``__``, and ``manifest.json`` (step, meta, each leaf's name, shape and
dtype).  Writes go to a ``.tmp_`` directory renamed into place (atomic on
POSIX), so a crash mid-save never corrupts the latest checkpoint; ``keep``
bounds the checkpoints kept.  ``save`` copies the tree to the host and can
write on a background thread; ``wait`` joins the write in flight.
``restore(template, device=...)`` loads each leaf into the template's
structure, shape and dtype, as torch tensors on ``device``.

bf16 leaves: numpy has no bfloat16, and the reference's ``np.save`` writes
its bf16 arrays as raw 2-byte voids (manifest dtype "bfloat16"), which its
own restore cannot cast back.  The port writes bf16 the same way, and reads
such a leaf back into a bf16 template bit for bit.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, path=()):
    """(path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(template, values):
    """``template``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values) for v in template)
    return next(values)


def _leaf_name(path) -> str:
    return "__".join(str(k) for k in path)


def _host(x) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name for the manifest)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        x = t.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _save(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; a bf16 leaf (2-byte voids) gets the header the
    reference's ``np.save`` of a bfloat16 array writes, '<V2'."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None,
             blocking: bool = True) -> pathlib.Path:
        """Snapshot ``tree`` at ``step``: copied to the host now, written
        now or (``blocking=False``) on a background thread."""
        host = [(_leaf_name(p), *_host(x)) for p, x in _leaves(tree)]
        if blocking:
            return self._write(step, host, meta)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, meta), daemon=True)
        self._thread.start()
        return self.dir / f"step_{step:010d}"

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, meta) -> pathlib.Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        for name, arr, dtype in host:
            _save(tmp / f"{name}.npy", arr, dtype)
            manifest["leaves"].append(
                {"name": name, "shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                     # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.match(r"step_(\d+)$", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None,
                device: str | torch.device = "cpu") -> tuple[Any, int]:
        """Load into the structure of ``template`` (a tree whose leaves have
        ``.shape`` and ``.dtype``: tensors or numpy arrays), as tensors of
        the template's dtypes on ``device``.  Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        src = self.dir / f"step_{step:010d}"
        out = []
        for path, tmpl in _leaves(template):
            name = _leaf_name(path)
            arr = np.load(src / f"{name}.npy")
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint leaf {name} shape {arr.shape} "
                    f"!= template {tuple(tmpl.shape)}")
            dtype = _torch_dtype(tmpl.dtype)
            if arr.dtype == np.dtype("V2"):
                if dtype != torch.bfloat16:
                    raise TypeError(f"checkpoint leaf {name} is bfloat16, "
                                    f"the template {dtype}")
                t = torch.from_numpy(arr.view(np.int16).copy()).view(dtype)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
            out.append(t.to(device))
        return _rebuild(template, iter(out)), step
