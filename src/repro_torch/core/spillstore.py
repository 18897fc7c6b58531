"""Memory-mapped chunk-granular spill store — the ``DiskHost`` tier's home.

A chunk (one transfer group: a layer's params, one data block) is one
binary file with every leaf at a 64-byte-aligned offset, described by a
JSON manifest with a CRC32 per leaf and per chunk.  The format is the JAX
package's (``repro.core.spillstore``) byte for byte: a chunk written by
either package reads in the other.

Reads are memory-mapped: ``get()`` returns a tree of zero-copy
:class:`SpillView` leaves (``np.memmap``), so referencing a spilled chunk
costs nothing; bytes move only when the transfer engine's disk stage copies
a leaf into a host buffer (that copy is the disk read).  One chunk = one
file = one disk request.  numpy has no bfloat16 on the card's machine, so a
bf16 leaf is viewed as ``uint16`` and carries ``spill_dtype == "bfloat16"``
(:func:`repro_torch.core.arrays.host_tensor` reads it back as bf16).

Writes are atomic (tmp file + ``os.replace``): an old memory map stays
valid, and the next ``get`` sees the new bytes.  The views carry their
provenance so the disk stage can verify the mapped bytes right before
consuming them (:func:`verify_disk_leaf`): a mismatch is re-read once, then
rebuilt through the store's ``recovery`` callback, and only then raised as
:class:`SpillCorruptionError`.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import dtype_name, dtype_of, host_tensor

__all__ = [
    "SpillStore",
    "SpillView",
    "SpillCorruptionError",
    "is_disk_leaf",
    "verify_disk_leaf",
]

log = logging.getLogger("repro_torch.spillstore")

Pytree = Any

#: leaf offsets inside a chunk file are padded to this many bytes
_ALIGN = 64

_MANIFEST = "manifest.json"


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _fname(key: str) -> str:
    """Filesystem-safe chunk file name for a key.  Sanitized names carry a
    short digest of the raw key so distinct keys never share a file."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "__", key)
    if safe != key:
        digest = hashlib.sha1(key.encode()).hexdigest()[:8]
        safe = f"{safe}-{digest}"
    return safe + ".bin"


def is_disk_leaf(x: Any) -> bool:
    """True if ``x`` is resident at the disk tier (a memory-mapped view)."""
    return isinstance(x, np.memmap)


def _leaf_bytes(leaf: Any) -> tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return dtype_name(t.dtype), list(t.shape), raw
    a = np.asarray(leaf)
    # tobytes, not memoryview: ml_dtypes' bfloat16 has no buffer protocol
    return dtype_name(dtype_of(leaf)), list(a.shape), np.ascontiguousarray(a).tobytes()


class SpillCorruptionError(RuntimeError):
    """A chunk's bytes no longer match their manifest CRC32; raised on fetch,
    never after the bytes were consumed."""

    def __init__(self, key: str, file: str, leaf_index: int, offset: int, nbytes: int,
                 expected: int, actual: int) -> None:
        self.key = key
        self.file = str(file)
        self.leaf_index = leaf_index
        self.offset = offset
        self.nbytes = nbytes
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"spill chunk {key!r} corrupt: leaf {leaf_index} at offset "
            f"{offset} ({nbytes} bytes) of {self.file} has crc32 "
            f"{actual:#010x}, manifest says {expected:#010x}"
        )


class SpillView(np.memmap):
    """A chunk leaf view carrying its provenance (store, chunk key, leaf
    index, byte range, manifest CRC) and, for bf16, its real dtype."""

    _SPILL_ATTRS = (
        "spill_store",
        "spill_key",
        "spill_leaf",
        "spill_offset",
        "spill_nbytes",
        "spill_crc32",
        "spill_base",
        "spill_dtype",
    )

    def __array_finalize__(self, obj):
        super().__array_finalize__(obj)
        for a in self._SPILL_ATTRS:
            if getattr(self, a, None) is None:
                setattr(self, a, getattr(obj, a, None))


def verify_disk_leaf(leaf: Any) -> Any:
    """CRC-check one fetched leaf view against its manifest checksum; on a
    mismatch re-read once, then rebuild through the store's ``recovery``
    callback, and only then raise :class:`SpillCorruptionError`.  Leaves
    without provenance, and partial views, pass through unverified."""
    crc = getattr(leaf, "spill_crc32", None)
    store = getattr(leaf, "spill_store", None)
    base = getattr(leaf, "spill_base", None)
    if crc is None or store is None or base is None:
        return leaf
    o, n = leaf.spill_offset, leaf.spill_nbytes
    if n != leaf.size * leaf.dtype.itemsize:
        return leaf  # partial view: a whole-leaf CRC cannot attribute it
    if zlib.crc32(base[o : o + n]) == crc:
        return leaf
    actual = zlib.crc32(base[o : o + n])  # one re-read before declaring rot
    if actual == crc:
        return leaf
    store.crc_failures += 1
    err = SpillCorruptionError(leaf.spill_key, getattr(leaf, "filename", None) or "<unlinked>",
                               leaf.spill_leaf, o, n, crc, actual)
    log.error("%s", err)
    try:
        fresh = store.recover(leaf.spill_key)
    except KeyError:
        raise err from None
    return tr.leaves(fresh)[leaf.spill_leaf]


class SpillStore:
    """Chunk-granular tree spill store backed by memory-mapped binary files.

    Within a process the store remembers each chunk's tree structure, so
    ``get(key)`` rebuilds the original tree; a fresh process, or a chunk the
    JAX package wrote, needs ``template=`` to re-impose the structure.
    """

    def __init__(self, directory: "str | os.PathLike", *, ephemeral: bool = False,
                 recovery: Optional[Callable[[str], Pytree]] = None) -> None:
        """``ephemeral=True``: contents matter only for this process —
        ``close()`` deletes the directory and ``put`` skips fsync and the
        per-put manifest flush.  ``recovery`` rebuilds a chunk from its
        durable home; it is the one re-fetch a CRC mismatch gets."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.ephemeral = ephemeral
        self._lock = threading.Lock()
        self._treedefs: dict[str, Any] = {}
        self._recovery = recovery
        mpath = self.dir / _MANIFEST
        self._manifest: dict[str, Any] = json.loads(mpath.read_text()) if mpath.exists() else {}
        self.bytes_written: int = 0
        self.crc_failures: int = 0
        self.recoveries: int = 0

    def set_recovery(self, fn: Optional[Callable[[str], Pytree]]) -> None:
        self._recovery = fn

    # ------------------------------------------------------------------ write
    def put(self, key: str, tree: Pytree) -> None:
        """Persist one chunk atomically (tmp + rename); overwrites ``key``."""
        leaves, treedef = tr.flatten(tree)
        metas, blobs = [], []
        off = 0
        for leaf in leaves:
            name, shape, raw = _leaf_bytes(leaf)
            metas.append({"offset": off, "shape": shape, "dtype": name, "nbytes": len(raw)})
            blobs.append(raw)
            off = _align(off + len(raw))
        path = self.dir / _fname(key)
        tmp = path.with_suffix(".tmp")
        chunk_crc = 0
        with open(tmp, "wb") as f:
            pos = 0
            for meta, raw in zip(metas, blobs):
                f.write(b"\0" * (meta["offset"] - pos))
                meta["crc32"] = zlib.crc32(raw)
                chunk_crc = zlib.crc32(raw, chunk_crc)
                f.write(raw)
                pos = meta["offset"] + meta["nbytes"]
            if not self.ephemeral:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic commit; old memmaps stay valid
        entry = {"file": path.name, "total_bytes": off, "crc32": chunk_crc, "leaves": metas}
        with self._lock:
            self._treedefs[key] = treedef
            changed = self._manifest.get(key) != entry
            self._manifest[key] = entry
            if not self.ephemeral and changed:
                self._write_manifest()
        self.bytes_written += sum(m["nbytes"] for m in metas)

    def _write_manifest(self) -> None:
        tmp = self.dir / (_MANIFEST + ".tmp")
        tmp.write_text(json.dumps(self._manifest, indent=1))
        os.replace(tmp, self.dir / _MANIFEST)

    # ------------------------------------------------------------------- read
    def get(self, key: str, template: Optional[Pytree] = None) -> Pytree:
        """Tree of memory-mapped leaf views into the chunk file (zero-copy
        until the bytes are touched).  ``template`` re-imposes the tree
        structure when it is not known in this process.  Zero-length leaves
        come back as plain empty arrays (there are no bytes to map), bf16
        ones as empty CPU tensors."""
        entry = self._entry(key)
        mm = (np.memmap(self.dir / entry["file"], dtype=np.uint8, mode="r")
              if entry["total_bytes"] else np.empty((0,), np.uint8))
        views = []
        for i, meta in enumerate(entry["leaves"]):
            o, n, name = meta["offset"], meta["nbytes"], meta["dtype"]
            bf16 = name == "bfloat16"
            if not n:
                views.append(torch.empty(meta["shape"], dtype=torch.bfloat16) if bf16
                             else np.empty(meta["shape"], np.dtype(name)))
                continue
            v = mm[o : o + n].view(np.uint16 if bf16 else np.dtype(name)).reshape(meta["shape"])
            v = v.view(SpillView)
            v.spill_dtype = name if bf16 else None
            if meta.get("crc32") is not None:
                v.spill_store = self
                v.spill_key = key
                v.spill_leaf = i
                v.spill_offset = o
                v.spill_nbytes = n
                v.spill_crc32 = meta["crc32"]
                v.spill_base = mm
            views.append(v)
        treedef = self._treedefs.get(key)
        if treedef is None and template is not None:
            treedef = tr.structure(template)
            self._treedefs[key] = treedef
        if treedef is None:
            if len(views) == 1:
                return views[0]
            raise KeyError(f"chunk {key!r} was written by another process; pass template= "
                           "to reconstruct its tree structure")
        return tr.unflatten(treedef, views)

    def read(self, key: str, template: Optional[Pytree] = None) -> Pytree:
        """Materialized copy of a chunk (CPU tensors) — a full disk read."""
        return tr.tree_map(lambda v: host_tensor(v).clone(), self.get(key, template))

    # -------------------------------------------------------------- integrity
    def verify_chunk(self, key: str) -> None:
        """Recompute every leaf CRC of ``key``; raises
        :class:`SpillCorruptionError` at the first mismatch."""
        entry = self._entry(key)
        if not entry["total_bytes"]:
            return
        mm = np.memmap(self.dir / entry["file"], dtype=np.uint8, mode="r")
        for i, meta in enumerate(entry["leaves"]):
            expected = meta.get("crc32")
            if expected is None or not meta["nbytes"]:
                continue
            o, n = meta["offset"], meta["nbytes"]
            actual = zlib.crc32(mm[o : o + n])
            if actual != expected:
                self.crc_failures += 1
                raise SpillCorruptionError(key, entry["file"], i, o, n, expected, actual)

    def recover(self, key: str) -> Pytree:
        """Rewrite ``key`` through the ``recovery`` callback and return fresh
        views; ``KeyError`` when no recovery source is registered."""
        if self._recovery is None:
            raise KeyError(f"no recovery source registered for chunk {key!r}")
        tree = self._recovery(key)
        self.put(key, tree)
        self.recoveries += 1
        log.warning("spill chunk %r rewritten from its durable home", key)
        return self.get(key)

    # ------------------------------------------------------------- inspection
    def _entry(self, key: str) -> dict:
        try:
            return self._manifest[key]
        except KeyError:
            raise KeyError(f"no spilled chunk {key!r} in {self.dir}") from None

    def __contains__(self, key: str) -> bool:
        return key in self._manifest

    def keys(self) -> Iterator[str]:
        return iter(sorted(self._manifest))

    def nbytes(self, key: str) -> int:
        return sum(m["nbytes"] for m in self._entry(key)["leaves"])

    def total_bytes(self) -> int:
        return sum(self.nbytes(k) for k in self._manifest)

    # -------------------------------------------------------------- lifecycle
    def delete(self, key: str) -> None:
        entry = self._entry(key)
        with self._lock:
            del self._manifest[key]
            self._treedefs.pop(key, None)
            self._write_manifest()
        (self.dir / entry["file"]).unlink(missing_ok=True)

    def close(self, *, delete: Optional[bool] = None) -> None:
        """Forget in-memory state.  ``delete`` defaults to ``ephemeral``:
        run-private stores remove their directory, durable stores keep their
        files with the manifest flushed."""
        self._treedefs.clear()
        if delete is None:
            delete = self.ephemeral
        if delete:
            shutil.rmtree(self.dir, ignore_errors=True)
        elif self.ephemeral:
            self._write_manifest()

    def __enter__(self) -> "SpillStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"SpillStore({str(self.dir)!r}, chunks={len(self._manifest)})"
