"""Fault-tolerant checkpointing: atomic, async, resumable (port of
``repro.checkpointing.manager``).

Layout, as the reference's: <dir>/step_<n>/ with one .npy per tree leaf
(path-encoded names) plus manifest.json (shapes, dtypes, step, the caller's
extra, e.g. the data cursor).  Writes go to step_<n>.tmp/ and are published
with ``os.replace``, so a partial write is never visible.  numpy has no
bfloat16, so a bf16 leaf is saved as its 16-bit pattern (uint16) and the
manifest records "bfloat16"; every other dtype is saved as it is, so a
checkpoint the reference wrote (f32, int32) restores leaf for leaf.
``AsyncCheckpointer`` copies to host memory synchronously and writes on a
background thread; a DTensor leaf is saved as its whole value.  ``restore``
puts each leaf on the template leaf's device (or ``device``), or with
``shardings`` lays it out as a DTensor on a mesh, whatever the mesh it was
saved from: the elastic re-shard.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def _flatten(tree: Any, path=()) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (str(i),))
        return out
    return [("/".join(path), tree)]


def _unflatten_like(template: Any, leaves: dict[str, Any], path=()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves, path + (str(k),))
                for k in template}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_like(v, leaves, path + (str(i),))
               for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    return leaves["/".join(path)]


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as a host array to save, and the dtype the manifest records."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        arr = t.numpy().copy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()  # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self._write(step, [(name, _to_host(leaf)) for name, leaf in _flatten(tree)], extra)

    def _write(self, step: int, leaves: list, extra: dict | None) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, (arr, dtype) in leaves:
            fn = name.replace("/", "__") + ".npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape), "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, shardings: Any | None = None,
                device: str | torch.device | None = None) -> tuple[Any, dict]:
        """Restore into ``template``'s structure: each leaf a tensor of the
        saved dtype on ``device``, or else on the template leaf's device
        (the CPU for a leaf that is not a tensor).  With ``shardings`` (a
        matching tree of ``parallel.sharding.NamedSharding``: a spec on a
        mesh) each leaf becomes a DTensor on its mesh, each rank keeping its
        own slice of the saved value."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        where = dict(_flatten(template))
        placed = dict(_flatten(shardings)) if shardings is not None else {}
        leaves = {}
        for name, meta in manifest["leaves"].items():
            if name not in where:
                continue
            tmpl = where[name]
            dev = torch.device(device) if device is not None else (
                tmpl.device if isinstance(tmpl, torch.Tensor) else torch.device("cpu"))
            leaf = _from_host(np.load(d / meta["file"]), meta["dtype"],
                              torch.device("cpu") if name in placed else dev)
            leaves[name] = placed[name].place(leaf) if name in placed else leaf
        return _unflatten_like(template, leaves), manifest["extra"]


class AsyncCheckpointer:
    """Snapshot to host synchronously, write to disk asynchronously."""

    def __init__(self, mgr: CheckpointManager):
        self.mgr = mgr
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()                           # one in-flight write at a time
        # copied now: the caller updates its tensors in place on the next step
        host = [(name, _to_host(leaf)) for name, leaf in _flatten(tree)]

        def work():
            try:
                self.mgr._write(step, host, extra)
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
