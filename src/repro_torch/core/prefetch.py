"""Graph streaming engine: pass-by-reference + prefetch over a ring of chunks.

The paper's runtime fetches referenced data on demand as the kernel walks
it, with an optional prefetch ring so transfers overlap compute (§3.1).
The JAX package runs this inside a compiled ``lax.scan``; PyTorch has no
compiled scan, so here the ring is a Python loop: the H2D copies of up to
``d`` chunks ahead are in flight on a dedicated copy stream, each chunk's
buffers marked as used by the compute stream, which waits on the chunk's
copy event just before using it.  ``d = 0`` is the paper's *on-demand*
mode: the fetch of every chunk is issued at use time, in its critical path.

Chunk = ``elements_per_fetch`` consecutive rows (layers, blocks) of the
streamed leading axis — the paper's chunked transfers.  The values never
depend on ``(distance, elements_per_fetch)``: the same function runs on the
same rows in the same order; only the copy schedule changes.

Under a mesh, ``device_shardings`` gives each streamed row's layout (a
tree of :class:`~repro_torch.core.memkind.Sharding`); a chunk lands at it
with the chunk's leading axis unsharded (the JAX package's leading
``None``), each rank copying its own shard.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterator, Optional, Sequence

import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.core.engine import static_auto_distance
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "chunk_shardings",
    "fetch_chunk",
    "eager_transfer",
    "streamed_scan",
    "stream_blocks",
]

Pytree = Any


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    t = host_tensor(x)
    return t if t.device == device else t.to(device, non_blocking=True)


def fetch_chunk(stacked: Pytree, idx: "int | slice", device: DeviceLike = None,
                shardings: Optional[Pytree] = None) -> Pytree:
    """On-demand fetch of one chunk: host-side slice + explicit H2D copy
    (the paper's §4 "blocking calls, to copy data on or off the device").
    Leaves already on ``device`` are only sliced.  ``shardings`` (chunk
    layouts, :func:`chunk_shardings`) land the rank's shard of each leaf as
    a DTensor."""
    dev = resolve_device(device)
    if shardings is None:
        return tr.tree_map(lambda a: _to_device(host_tensor(a)[idx], dev), stacked)
    return tr.tree_map(lambda a, sh: _to_device(host_tensor(a)[idx], dev) if sh is None
                       else sh.put(host_tensor(a)[idx]), stacked, shardings)


def chunk_shardings(row_shardings: Optional[Pytree]) -> Optional[Pytree]:
    """Each row layout with a leading unsharded chunk axis: every
    ``Shard(d)`` becomes ``Shard(d + 1)`` (the JAX package's
    ``PartitionSpec(None, *spec)``)."""
    if row_shardings is None:
        return None
    import dataclasses

    from torch.distributed.tensor import Shard

    from repro_torch.core.memkind import Sharding

    def shift(sh):
        if sh is None:
            return None
        return dataclasses.replace(sh, placements=tuple(
            Shard(p.dim + 1) if isinstance(p, Shard) else p for p in sh.placements))

    flat, treedef = tr.flatten(row_shardings, is_leaf=lambda x: x is None or isinstance(x, Sharding))
    return tr.unflatten(treedef, [shift(x) for x in flat])


def eager_transfer(stacked: Pytree, device: DeviceLike = None) -> Pytree:
    """The paper's *eager* baseline: bulk-copy the whole argument to the
    device before any compute starts."""
    dev = resolve_device(device)
    return tr.tree_map(lambda a: _to_device(a, dev), stacked)


def _ring(fetch: Callable[[int], Pytree], n_chunks: int, d: int,
          dev: torch.device) -> Iterator[Pytree]:
    """Chunks 0..n-1 in order, on the device; the copy of chunk ``i + d`` is
    issued before chunk ``i`` is handed out."""
    copy = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    compute = torch.cuda.current_stream(dev) if copy is not None else None

    def issue(c: int):
        if copy is None:
            return fetch(c), None
        with torch.cuda.stream(copy):
            chunk = fetch(c)
            event = torch.cuda.Event()
            event.record(copy)
        for t in tr.leaves(chunk):
            # read there: no reuse before it is done
            (t.to_local() if hasattr(t, "to_local") else t).record_stream(compute)
        return chunk, event

    pending = deque(issue(c) for c in range(min(d, n_chunks)))
    for i in range(n_chunks):
        if i + d < n_chunks:
            pending.append(issue(i + d))  # d == 0: chunk i itself, at use time
        chunk, event = pending.popleft()
        if event is not None:
            compute.wait_event(event)
        yield chunk


def _distance(prefetch: PrefetchSpec, n_chunks: int) -> int:
    # "auto" cannot adapt a ring sized up front: resolve it to a fixed head
    # start, as the JAX package does at trace time
    return min(prefetch.numeric_distance(static_auto_distance(n_chunks)), max(n_chunks - 1, 0))


def streamed_scan(
    body_fn: Callable[[Pytree, Pytree], tuple[Pytree, Pytree]],
    init_carry: Pytree,
    stacked_params: Pytree,
    *,
    prefetch: PrefetchSpec,
    device: DeviceLike = None,
    length: Optional[int] = None,
    device_shardings: Optional[Pytree] = None,
) -> tuple[Pytree, Pytree]:
    """A scan over stacked (leading-axis ``L``) parameters with streaming.

    ``body_fn(carry, layer_params) -> (carry, y)`` is applied to each of the
    ``L`` layers in order.  Parameters are fetched chunk-wise
    (``prefetch.elements_per_fetch`` layers per transfer) through a ring of
    ``distance`` chunks in flight.  Returns ``(final_carry, ys)`` with
    ``ys`` stacked on axis 0 (``None`` if the body returns no ``y``).
    ``device_shardings``: each layer's layout under a mesh (the chunks land
    at :func:`chunk_shardings` of it).
    """
    leaves = tr.leaves(stacked_params)
    if not leaves:
        raise ValueError("streamed_scan requires at least one parameter leaf")
    n_layers = length if length is not None else leaves[0].shape[0]
    g = prefetch.elements_per_fetch
    if n_layers % g != 0:
        raise ValueError(f"n_layers={n_layers} not divisible by elements_per_fetch={g}")
    n_chunks = n_layers // g
    dev = resolve_device(device)
    carry, ys = init_carry, []
    csh = chunk_shardings(device_shardings)
    fetch = lambda c: fetch_chunk(stacked_params, slice(c * g, (c + 1) * g), dev, csh)  # noqa: E731
    for chunk in _ring(fetch, n_chunks, _distance(prefetch, n_chunks), dev):
        for j in range(g):
            carry, y = body_fn(carry, tr.tree_map(lambda a: a[j], chunk))
            ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tr.tree_map(lambda *xs: torch.stack(xs), *ys)


def stream_blocks(
    fn: Callable[..., Pytree],
    args: Sequence[Pytree],
    *,
    prefetch: PrefetchSpec,
    device: DeviceLike = None,
    device_shardings: Optional[Sequence[Pytree]] = None,
) -> Pytree:
    """Chunked map over the leading axis of host-resident arrays — the
    paper's Listing-2 pattern (kernels over data larger than the device).
    ``device_shardings``: one row layout per argument under a mesh.

    ``fn(*blocks) -> out_block`` is applied to aligned blocks of
    ``prefetch.elements_per_fetch`` rows (fn sees the whole block); the
    outputs are concatenated.  The ring overlaps the copy of block
    ``i + distance`` with the compute of block ``i``.
    """
    g = prefetch.elements_per_fetch
    n = tr.leaves(args[0])[0].shape[0]
    if n % g != 0:
        raise ValueError(f"leading axis {n} not divisible by elements_per_fetch={g}")
    n_chunks = n // g
    dev = resolve_device(device)
    csh = (tuple(chunk_shardings(s) for s in device_shardings)
           if device_shardings is not None else None)
    fetch = lambda c: fetch_chunk(tuple(args), slice(c * g, (c + 1) * g), dev, csh)  # noqa: E731
    outs = [fn(*block) for block in _ring(fetch, n_chunks, _distance(prefetch, n_chunks), dev)]
    return tr.tree_map(lambda *xs: torch.cat(xs), *outs)
