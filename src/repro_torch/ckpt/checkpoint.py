"""Checkpoint/restart with manifests in the metadata plane.

Tensor shards are written per (param leaf x shard) — at scale each host
writes its local shards in parallel — and registered as rows in the HopsFS
namespace. Commit is the paper's subtree rename (atomic at the root), so a
writer crash mid-checkpoint leaves only an uncommitted ``.tmp`` tree that
the next GC sweep removes; restore always sees a complete manifest or none
(fault tolerance for 1000+ node fleets).

Async mode double-buffers: the step returns as soon as arrays are snapshot
to host memory; serialization + manifest writes happen on a worker thread.

The parameter trees hold tensors, on the card or the host.  ``save`` copies
each leaf to the host and writes it with numpy, in the JAX package's file
layout and bytes (a bf16 leaf as its raw 2-byte words under the ``'<V2'``
header that numpy writes for a bfloat16 array), so a checkpoint written by
either package restores in the other; ``restore_latest`` gives tensors on
the manager's ``device`` back.

A step's files are written under ``step-<n>.tmp`` and the directory is
renamed to ``step-<n>`` once the plane has committed it, so the disk
shows which checkpoints were committed.  A trainer restarted in a new
process meets a new in-memory plane, where the HopsFS cluster it stands
for would have kept the manifests: ``register_committed`` enters the
committed directories into it again, as their writer did.
"""
from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..metaplane import MetadataPlane

#: the header numpy writes for a bfloat16 array: two raw bytes an element
_BF16_DESCR = "<V2"


def _to_host(v: Any) -> np.ndarray:
    if not torch.is_tensor(v):
        return np.asarray(v)
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.dtype("V2"))
    return v.numpy()


def _save(path: Path, arr: np.ndarray) -> None:
    if arr.dtype != np.dtype("V2"):
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return root


class CheckpointManager:
    def __init__(self, directory: str, plane: MetadataPlane, job: str,
                 *, keep: int = 2, async_mode: bool = False,
                 device: Any = None):
        self.dir = Path(directory)
        #: where restored tensors go: the card unless ``device="cpu"``
        self.device = resolve_device(device)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.plane = plane
        self.job = job
        self.keep = keep
        self.async_mode = async_mode
        self._worker: Optional[threading.Thread] = None
        plane.open_job(job)

    # ------------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any) -> None:
        flat = _flatten({"params": params, "opt": opt_state})
        host = {k: _to_host(v) for k, v in flat.items()}
        if self.async_mode:
            self._join()
            self._worker = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._worker.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> None:
        base = self.plane.begin_checkpoint(self.job, step)
        step_dir = self.dir / f"step-{step:08d}"
        tmp_dir = self.dir / f"step-{step:08d}.tmp"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        for path, arr in host.items():
            fname = path.replace("/", "~") + ".shard-00000.npy"
            _save(tmp_dir / fname, arr)
            self.plane.add_shard(base, path, 0)
        self.plane.commit_checkpoint(self.job, step)
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.rename(step_dir)
        self._gc()

    def register_committed(self) -> List[int]:
        """Enter into the plane every committed step directory on disk
        that it does not list (a new process's plane lists none); returns
        their steps."""
        known = set(self.plane.client.execute(
            "ls", f"/ckpt/{self.job}").value)
        added = []
        for d in sorted(self.dir.glob("step-*")):
            if not d.is_dir() or d.name.endswith(".tmp") or d.name in known:
                continue
            step = int(d.name.split("-")[1])
            base = self.plane.begin_checkpoint(self.job, step)
            for f in sorted(d.glob("*.npy")):
                path, shard = f.name[:-len(".npy")].rsplit(".shard-", 1)
                self.plane.add_shard(base, path.replace("~", "/"),
                                     int(shard))
            self.plane.commit_checkpoint(self.job, step)
            added.append(step)
        return added

    def _gc(self) -> None:
        names = self.plane.client.execute("ls", f"/ckpt/{self.job}").value
        steps = sorted(int(n.split("-")[1]) for n in names
                       if n.startswith("step-") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            self.plane.gc_checkpoint(self.job, s)
            d = self.dir / f"step-{s:08d}"
            if d.exists():
                for f in d.iterdir():
                    f.unlink()
                d.rmdir()

    def _join(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    # ------------------------------------------------------------------
    def restore_latest(self) -> Optional[Tuple[int, Any, Any]]:
        self._join()
        step = self.plane.latest_checkpoint(self.job)
        if step is None:
            return None
        man = self.plane.manifest(self.job, step)
        assert man.complete, "manifest incomplete after commit"
        step_dir = self.dir / f"step-{step:08d}"
        flat = {}
        for path in man.shards:
            fname = path.replace("/", "~") + ".shard-00000.npy"
            flat[path] = _to_tensor(np.load(step_dir / fname),
                                    self.device)
        tree = _unflatten(flat)
        return step, tree["params"], tree["opt"]
