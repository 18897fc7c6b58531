"""Fault-tolerant checkpointing: atomic, async, keep-k.

The JAX package's ``checkpoint/manager.py``, with its on-disk format, so
either package restores the other's checkpoints:

  * **atomicity** — each checkpoint is written to ``step_XXXX.tmp`` and
    renamed only after every leaf + metadata has been fsync'd; a crash
    mid-write can never corrupt the latest checkpoint.
  * **async** — ``save()`` snapshots device leaves to host memory and hands
    the serialization to a background thread; the train loop blocks only for
    the D2H copy (and ``wait()`` joins before the next save).
  * **keep-k** — old checkpoints are pruned after a successful commit.
  * **restore anywhere** — leaves are saved whole with their logical tree
    paths; ``restore(..., device=...)`` places them on a device, or leaves
    them as host numpy.

Format: one ``.npy`` per leaf (path-encoded filename: dict keys and sequence
indices joined by ``__``, as ``jax.tree_util.tree_flatten_with_path`` names
them) + ``meta.json`` (step, tree structure, dtypes/shapes).  bf16 leaves
are written as the JAX package writes them (``ml_dtypes``' bfloat16 under
``np.save``: a ``<V2`` void array) and re-viewed on load through the dtype
``meta.json`` records — here through ``uint16``, since numpy has no bf16
without ``ml_dtypes``: a :class:`~repro_torch.core.arrays.BF16HostArray`,
or ``torch.bfloat16`` on a device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import BF16HostArray, dtype_name, host_array, host_tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.local import is_dtensor

Pytree = Any

_SEP = "__"

# 8+ digits: f"{step:08d}" pads but never truncates, so steps >= 10^8
# produce wider names that must stay visible to restore/prune
_STEP_RE = re.compile(r"step_(\d{8,})$")

#: the npy descriptor ``np.save`` gives ml_dtypes' bfloat16
_BF16_DESCR = "<V2"


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a rename committed into it survives power loss
    (best-effort: some filesystems refuse O_RDONLY dir fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - exotic fs
        pass
    finally:
        os.close(fd)


def _paths(node: Any, prefix: tuple, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], prefix + (str(k),), out)
    elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        for i, x in enumerate(node):
            _paths(x, prefix + (str(i),), out)
    elif node is not None:
        out.append((_SEP.join(prefix), node))


def _flatten(tree: Pytree) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs in the tree's leaf order."""
    out: list = []
    _paths(tree, (), out)
    return out


def _dtype(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return dtype_name(x.dtype)
    return getattr(x, "spill_dtype", None) or str(np.asarray(x).dtype)


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _host_leaf(x: Any) -> Any:
    """A snapshot of one leaf for the writer thread.  Device tensors are
    copied to host now (the next step may reuse their memory); host leaves
    (CPU tensors, numpy arrays, spill-store views: the homes the steps
    replace, never mutate) are kept by reference, so a host- or disk-homed
    state never materializes whole; anything else snapshots eagerly.  A
    DTensor is gathered whole (``full_tensor``, a collective every rank
    runs): checkpoints hold unsharded leaves, the reference's format."""
    if is_dtensor(x):
        return x.full_tensor().detach().cpu()
    sharding = getattr(x, "sharding", None)
    if sharding is not None and hasattr(x, "local"):  # a rank's host shard
        from repro_torch.core.memkind import DEVICE

        return _host_leaf(type(sharding)(sharding.mesh, sharding.placements, DEVICE).put(x))
    if isinstance(x, torch.Tensor):
        return x.detach() if x.device.type == "cpu" else x.detach().cpu()
    return x if isinstance(x, np.ndarray) else np.asarray(x)


def _as_numpy(x: Any) -> np.ndarray:
    """The leaf's bytes as numpy (bf16 as ``uint16``)."""
    if isinstance(x, torch.Tensor):
        x = host_array(x.contiguous())
    a = np.asarray(x)
    return a.view(np.uint16) if _dtype(x) == "bfloat16" else a


def _review(arr: np.ndarray, dtype: Optional[str]) -> np.ndarray:
    """A loaded void array re-viewed through the dtype ``meta.json`` names."""
    if arr.dtype.kind != "V" or dtype is None:
        return arr
    if dtype != "bfloat16":
        raise TypeError(f"checkpoint leaf of extension dtype {dtype!r}: only bfloat16 is read")
    return arr.view(np.uint16).view(BF16HostArray)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3) -> None:
        """``keep``: checkpoints retained after each commit.  ``keep=0``
        explicitly means *keep all* (no pruning); negative values are
        rejected rather than silently keeping everything.

        Construction sweeps crash leftovers (partial ``.tmp`` dirs are
        deleted, an orphaned ``.old`` is recovered as its step) so a
        restart restores the right step BEFORE its first save.  The
        manager therefore assumes a single writer per directory."""
        if keep < 0:
            raise ValueError(f"keep must be >= 0 (0 = keep all), got {keep}")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: a sharded save's barrier, met by every rank at :meth:`wait`
        self._barrier = False
        self._sweep_stale()

    def _sweep_stale(self) -> None:
        """Remove leftovers of a crashed save: ``.tmp`` dirs are always
        partial (pre-commit) and are deleted; a ``.old`` dir is the
        previous copy of a step that was mid-overwrite — restore it when
        the crash hit before the commit rename, drop it otherwise."""
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
        for p in self.dir.glob("step_*.old"):
            final = self.dir / p.name[: -len(".old")]
            if final.exists():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.rename(final)

    # ------------------------------------------------------------------ save
    def save(
        self,
        step: int,
        tree: Pytree,
        *,
        blocking: bool = False,
        extra_meta: Optional[dict] = None,
    ) -> None:
        """Snapshot ``tree`` at ``step``.  D2H happens here (synchronous);
        file I/O happens on a background thread unless ``blocking``.

        ``extra_meta`` is recorded verbatim under ``meta.json``'s ``extra``
        key (the driver stores its run identity there).

        Under a process group every rank saves together (the directory has
        one writer): each DTensor leaf is gathered here, rank 0 writes, and
        every rank meets the others at a barrier in :meth:`wait` (the next
        save, or the driver's restore, calls it), so none reads the
        directory before the step is committed."""
        self.wait()
        host = [(name, _host_leaf(x)) for name, x in _flatten(tree)]
        if _in_group():
            import torch.distributed as dist

            self._barrier = True
            if dist.get_rank() != 0:
                if blocking:
                    self.wait()
                return
        meta = {
            "step": int(step),
            "treedef": repr(tr.structure(tree)),
            "leaves": [
                {"name": n, "shape": list(a.shape), "dtype": _dtype(a)} for n, a in host
            ],
            "time": time.time(),
        }
        if extra_meta:
            meta["extra"] = dict(extra_meta)

        def write() -> None:
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for name, arr in host:
                    self._write_leaf(tmp, name, arr)
                with open(tmp / "meta.json", "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                self._commit(step, tmp)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    @staticmethod
    def _write_leaf(tmp: Path, name: str, arr: Any) -> None:
        with open(tmp / f"{name}.npy", "wb") as f:
            a = _as_numpy(arr)
            if _dtype(arr) == "bfloat16":
                a = np.ascontiguousarray(a)
                np.lib.format.write_array_header_1_0(
                    f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
                f.write(a.tobytes())
            else:
                np.save(f, np.asarray(a))
            f.flush()
            os.fsync(f.fileno())

    def _commit(self, step: int, tmp: Path) -> None:
        """Atomically promote a fully-written ``.tmp`` dir to the step dir.

        Overwrite without a crash window: the previous copy moves aside and
        is deleted only AFTER the rename commits — a crash between the two
        never loses the only copy of a step."""
        final = self.dir / f"step_{step:08d}"
        old = None
        if final.exists():
            old = self.dir / f"step_{step:08d}.old"
            if old.exists():
                shutil.rmtree(old)
            final.rename(old)
        try:
            tmp.rename(final)  # the atomic commit
        except BaseException:
            if old is not None and not final.exists():
                old.rename(final)  # roll back: old copy stays latest
            raise
        _fsync_dir(self.dir)  # the rename itself must be durable
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        self._prune()

    def save_streamed(
        self,
        step: int,
        leaves,
        *,
        extra_meta: Optional[dict] = None,
        treedef: str = "streamed",
    ) -> None:
        """Write a checkpoint from an *iterator* of ``(name, array)`` pairs,
        holding one leaf in memory at a time.  Synchronous; commits with the
        same atomic tmp -> rename (+ ``.old`` crash window) as :meth:`save`.
        ``restore`` imposes structure from its *template*, so ``treedef``
        may be a placeholder."""
        self.wait()
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        leaf_meta = []
        for name, arr in leaves:
            arr = _host_leaf(arr)
            self._write_leaf(tmp, name, arr)
            leaf_meta.append({"name": name, "shape": list(arr.shape), "dtype": _dtype(arr)})
        meta = {"step": int(step), "treedef": treedef, "leaves": leaf_meta, "time": time.time()}
        if extra_meta:
            meta["extra"] = dict(extra_meta)
        with open(tmp / "meta.json", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        self._commit(step, tmp)

    def wait(self) -> None:
        """Join the in-flight write (and meet the other ranks after a
        sharded save)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist

            self._barrier = False
            dist.barrier()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _prune(self) -> None:
        steps = self.all_steps()
        # keep=0 means keep all (see __init__)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(
            int(m.group(1))
            for p in self.dir.glob("step_*")
            if p.is_dir() and (m := _STEP_RE.fullmatch(p.name))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_meta(self, step: Optional[int] = None) -> dict:
        """The stored ``meta.json`` of ``step`` (default: latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return json.loads((self.dir / f"step_{step:08d}" / "meta.json").read_text())

    def load_leaf(
        self,
        step: int,
        name: str,
        *,
        dtype: Optional[str] = None,
        mmap: bool = False,
    ) -> np.ndarray:
        """One stored leaf by name.  ``mmap=True`` maps it read-only.
        ``dtype`` (from :meth:`load_meta`) re-views bf16 as :meth:`restore`
        does."""
        arr = np.load(self.dir / f"step_{step:08d}" / f"{name}.npy",
                      mmap_mode="r" if mmap else None)
        return _review(arr, dtype)

    def restore(
        self,
        template: Pytree,
        *,
        step: Optional[int] = None,
        device: DeviceLike = None,
        shardings: Optional[Pytree] = None,
    ) -> tuple[int, Pytree]:
        """Load into the structure of ``template`` (any tree of the state's
        structure: meta tensors will do).  Leaves come back as host numpy
        (bf16 as :class:`~repro_torch.core.arrays.BF16HostArray`), or as
        tensors on ``device`` when one is given.  ``shardings`` (a matching
        tree of :class:`~repro_torch.core.memkind.Sharding`, ``None`` entries
        left as host numpy) re-places the full leaves under any mesh: each
        rank takes its own shard (the elastic resume)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in meta["leaves"]}
        leaves = [_review(np.load(d / f"{name}.npy"), dtypes.get(name))
                  for name, _ in _flatten(template)]
        if device is not None:
            dev = resolve_device(device)
            leaves = [host_tensor(a).to(dev) for a in leaves]
        tree = tr.unflatten(tr.structure(template), leaves)
        if shardings is not None:
            from repro_torch.core.memkind import Sharding

            flat = tr.flatten(shardings, is_leaf=lambda x: x is None or isinstance(x, Sharding))[0]
            tree = tr.unflatten(tr.structure(template),
                                [a if sh is None else sh.put(a) for a, sh in zip(leaves, flat)])
        return step, tree
