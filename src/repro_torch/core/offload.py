"""The ``@offload`` decorator — paper Listings 1-3.

Paper semantics: decorating a function with ``@offload`` makes calls
execute on the accelerator; arguments are passed **by reference** and the
runtime moves data according to each argument's memory kind and optional
prefetch annotation.

Here "the accelerator" is one CUDA device (the CPU only when the caller
passes ``device="cpu"``), and an argument with a ``spec`` is placed on a
mesh over the ranks (:meth:`OffloadedFunction.mesh`).  Each argument is placed at its declared level
(:func:`repro_torch.core.memkind.place`); host-kind arguments annotated with
a ``PrefetchSpec`` are streamed block-wise through the device
(:func:`repro_torch.core.prefetch.stream_blocks`) instead of bulk-copied.

Example (paper Listing 3 analogue)::

    from repro_torch.core import offload, OffloadRef, PrefetchSpec, memkind as mk

    spec = PrefetchSpec(buffer_size=10, elements_per_fetch=2, distance=4)

    @offload(refs=dict(a=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec),
                       b=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec)))
    def mykernel(a, b):
        return a + b
"""
from __future__ import annotations

import functools
import inspect
import pathlib
import tempfile
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.core import memkind as mk
from repro_torch.core import prefetch as pf
from repro_torch.core import tree as tr
from repro_torch.core.refspec import OffloadRef
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["offload", "OffloadedFunction"]


def _default_mesh(device: torch.device):
    """A ``("data",)`` mesh over every rank (a one-rank group is opened
    when there is none)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device.type, (dist.get_world_size(),), mesh_dim_names=("data",))


class OffloadedFunction:
    """Callable produced by ``@offload``.  Keeps the paper's behaviours:

    * ``__call__`` — run on the device, honouring each ref's kind+prefetch.
    * ``.eager``   — force the paper's original bulk-copy invocation.
    * ``.place(name, value)`` — the paper's ``define_on_device`` /
      ``copy_to_device``: put an argument at its declared kind ahead of the
      call so repeated invocations skip the transfer.
    * ``.stream_host`` — streamed refs served by the host-side transfer engine.
    """

    def __init__(self, fn: Callable[..., Any], refs: Mapping[str, OffloadRef],
                 device: DeviceLike = None, mesh=None) -> None:
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._refs = dict(refs)
        self._device = device
        self._mesh = mesh
        self._signature = inspect.signature(fn)
        self._params = list(self._signature.parameters)
        unknown = set(refs) - set(self._params)
        if unknown:
            raise ValueError(f"refs for unknown arguments: {sorted(unknown)}")
        #: host-stream executors, keyed on (streamed-arg set, per-arg memory
        #: kinds, engine identity) — see stream_host
        self._stream_host_cache: dict[tuple, Any] = {}
        #: lazily-created spill store for DiskHost-kind streamed args
        self._spill_store: Any = None

    # -- placement helpers ---------------------------------------------------
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def mesh(self):
        """The mesh the sharded (``spec``) arguments are placed on: the one
        given, else a ``("data",)`` mesh over the ranks (the JAX package's
        ``_default_mesh``)."""
        if self._mesh is None:
            self._mesh = _default_mesh(self.device())
        return self._mesh

    def _ref(self, name: str) -> OffloadRef:
        return self._refs.get(name, OffloadRef())

    def _sharded(self, name: str) -> bool:
        return self._ref(name).spec is not None

    def _sharding(self, name: str, kind) -> mk.Sharding:
        from repro_torch.parallel.sharding import P

        return mk.sharding_for(self.mesh(), P(*self._ref(name).spec), kind)

    def place(self, name: str, value: Any) -> Any:
        """Put ``value`` at the argument's declared hierarchy level (a
        sharded argument at its sharding: each rank's shard)."""
        if name not in self._params:
            raise ValueError(f"{name!r} is not an argument of {self._fn.__name__}")
        if self._sharded(name):
            return tr.tree_map(self._sharding(name, self._ref(name).kind).put, value)
        return mk.place(value, self._ref(name).kind, self.device())

    # -- invocation ----------------------------------------------------------
    def _call(self, streamed: bool, *args: Any, **kwargs: Any) -> Any:
        bound = self._signature.bind(*args, **kwargs)
        bound.apply_defaults()
        dev = self.device()
        stream_names = [n for n in self._params if streamed and self._ref(n).streamed]
        # materialize at home kinds (pass-by-reference: host args stay host);
        # a streamed sharded argument stays whole at its home kind and
        # lands chunk by chunk at its sharding
        placed = {n: (mk.place(v, self._ref(n).kind, dev) if n in stream_names
                      else self.place(n, v)) for n, v in bound.arguments.items()}
        fixed = {n: (tr.tree_map(self._sharding(n, mk.DEVICE).put, v) if self._sharded(n)
                     else pf.eager_transfer(v, dev))
                 for n, v in placed.items() if n not in stream_names}
        if not stream_names:
            return self._fn(**fixed)
        # streamed refs are processed block-wise over their leading axis (all
        # must agree on its length); fn must be a per-block map for this path
        spec = self._ref(stream_names[0]).prefetch

        def block_fn(*blocks):
            return self._fn(**fixed, **dict(zip(stream_names, blocks)))

        rows = None
        if any(self._sharded(n) for n in stream_names):
            from repro_torch.parallel.sharding import P

            # a chunk's layout: the spec's row part, the chunk axis unsharded
            rows = [mk.sharding_for(self.mesh(), P(*self._ref(n).spec[1:]), mk.DEVICE)
                    if self._sharded(n) else None for n in stream_names]
        return pf.stream_blocks(block_fn, tuple(placed[n] for n in stream_names),
                                prefetch=spec, device=dev, device_shardings=rows)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._call(True, *args, **kwargs)

    def eager(self, *args: Any, **kwargs: Any) -> Any:
        """Paper's original eager-copy invocation (bulk transfer, then run)."""
        return self._call(False, *args, **kwargs)

    def stream_host(
        self,
        *args: Any,
        mode: str = "prefetch",
        engine: Any = None,
        stats: Any = None,
        policy: Optional[mk.PlacementPolicy] = None,
        spill_dir: Any = None,
        **kwargs: Any,
    ) -> Any:
        """Run with streamed refs served by the host-side transfer engine
        (the paper's §4 runtime): streamed arguments stay where the caller
        keeps them (numpy or CPU tensors), a background
        :class:`~repro_torch.core.engine.TransferEngine` coalesces and
        prefetches blocks ahead of the per-block apply, and each block's
        output is written back to the host (``rw``).  Returns the outputs
        concatenated along axis 0, as CPU tensors; the same values as
        ``__call__`` and ``.eager``.

        ``policy`` overrides the home tier of every streamed argument with
        its ``params`` kind.  ``DiskHost`` spills each block to a
        :class:`~repro_torch.core.spillstore.SpillStore` (under
        ``spill_dir``, or a private temporary directory deleted on
        :meth:`close`) and streams it disk -> host -> device.  The executor
        is cached per (streamed-arg set, kinds, engine); :meth:`close`
        releases the workers.
        """
        from repro_torch.core.hoststream import HostStreamExecutor

        bound = self._signature.bind(*args, **kwargs)
        bound.apply_defaults()
        stream_names = [n for n in self._params if self._ref(n).streamed]
        if not stream_names:
            return self(*args, **kwargs)
        spec = self._ref(stream_names[0]).prefetch
        g = spec.elements_per_fetch
        kinds = tuple(policy.params if policy is not None else self._ref(n).kind
                      for n in stream_names)
        dev = self.device()
        fixed = {n: pf.eager_transfer(self.place(n, v), dev)
                 for n, v in bound.arguments.items() if n not in stream_names}
        streamed_vals = {n: bound.arguments[n] for n in stream_names}
        n_rows = tr.leaves(streamed_vals[stream_names[0]])[0].shape[0]
        if n_rows % g != 0:
            raise ValueError(f"leading axis {n_rows} not divisible by elements_per_fetch={g}")

        key = (tuple(stream_names), tuple(k.jax_kind for k in kinds),
               id(engine) if engine is not None else None)
        ex = self._stream_host_cache.get(key)
        if ex is None:
            base = self._fn

            def apply(carry, block):
                return carry, base(**carry, **dict(zip(stream_names, block)))

            ex = HostStreamExecutor(apply, writeback=True, engine=engine,
                                    device=None if engine is not None else dev)
            self._stream_host_cache[key] = ex

        groups = [
            tuple(tr.tree_map(lambda a: a[i:i + g], streamed_vals[n]) for n in stream_names)
            for i in range(0, n_rows, g)
        ]
        if any(not k.jax_addressable for k in kinds):
            groups = [self._spill(f"g{i:04d}", grp, spill_dir) for i, grp in enumerate(groups)]
        _, outs = ex.run(fixed, groups, mode=mode, prefetch=spec, stats=stats)
        return tr.tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)

    def _spill(self, key: str, group: Any, spill_dir: Any) -> Any:
        """Move one block to the DiskHost tier: persist it in the spill store
        and return its memory-mapped view tree.  A private temporary store is
        ephemeral (deleted on close); a caller's ``spill_dir`` is durable."""
        from repro_torch.core.spillstore import SpillStore

        if self._spill_store is not None and spill_dir is not None:
            if pathlib.Path(spill_dir) != self._spill_store.dir:
                raise ValueError(
                    f"stream_host already bound a spill store at {str(self._spill_store.dir)!r}; "
                    f"close() before switching to spill_dir={str(spill_dir)!r}"
                )
        if self._spill_store is None:
            ephemeral = spill_dir is None
            if ephemeral:
                spill_dir = tempfile.mkdtemp(prefix=f"repro-spill-{self._fn.__name__}-")
            self._spill_store = SpillStore(spill_dir, ephemeral=ephemeral)
        self._spill_store.put(key, group)
        return self._spill_store.get(key)

    def close(self) -> None:
        """Shut down the host-stream executors (and their engine workers), and
        drop the spill store (deleting it if privately created)."""
        for ex in self._stream_host_cache.values():
            ex.close()
        self._stream_host_cache.clear()
        if self._spill_store is not None:
            self._spill_store.close()
            self._spill_store = None

    def lower(self, *args: Any, streamed: bool = True, **kwargs: Any):
        """Lower without executing (the dry-run's path): the call traced on
        meta tensors of the arguments' shapes (tensors, numpy arrays or meta
        tensors; no data is read, nothing runs), returned as a
        :class:`~repro_torch.core.lowering.Lowered`, with the true memory
        kinds.  An argument at a host kind counts in ``host_bytes``, not
        in the device's arguments.  Without streaming a host argument is
        copied whole to the device for the call (``temp``).  A streamed one
        (``streamed=True``) holds the device only through its
        ``PrefetchSpec`` ring, ``distance + 1`` blocks of
        ``elements_per_fetch`` rows: ``fn`` is traced once on one block's
        shapes and the call's FLOPs, bytes and outputs are the block's
        times the blocks."""
        from repro_torch.core import lowering as lw

        bound = self._signature.bind(*args, **kwargs)
        bound.apply_defaults()
        vals = {n: lw.meta_like(v) for n, v in bound.arguments.items()}
        on_host = [n for n in vals if not self._ref(n).kind.directly_addressable]
        host_bytes = lw.tensor_bytes([vals[n] for n in on_host])
        stream_names = [n for n in self._params if streamed and self._ref(n).streamed]
        fixed = {n: v for n, v in vals.items() if n not in stream_names}
        fixed_dev = lw.tensor_bytes([v for n, v in fixed.items() if n not in on_host])
        if not stream_names:
            low = lw.lower(self._fn, **vals)
            low.argument_bytes, low.host_bytes = fixed_dev, host_bytes
            return low
        spec = self._ref(stream_names[0]).prefetch
        g = spec.elements_per_fetch
        n_rows = tr.leaves(vals[stream_names[0]])[0].shape[0]
        if n_rows % g != 0:
            raise ValueError(f"leading axis {n_rows} not divisible by elements_per_fetch={g}")
        n_chunks = n_rows // g
        blocks = [tr.tree_map(lambda a: torch.empty((g, *a.shape[1:]), dtype=a.dtype,
                                                    device="meta"), vals[n])
                  for n in stream_names]
        block = lw.lower(lambda *b, **kw: self._fn(**kw, **dict(zip(stream_names, b))),
                         *blocks, **fixed)
        window = min(pf._distance(spec, n_chunks) + 1, n_chunks) * lw.tensor_bytes(blocks)
        own = block.peak_bytes - block.argument_bytes - block.output_bytes  # a block's temporaries
        out = n_chunks * block.output_bytes
        fixed_all = lw.tensor_bytes(list(fixed.values()))  # host ones copied in bulk
        # the ring's last block beside every block's output, then the
        # outputs beside their concatenation
        peak = fixed_all + max(window + own + out, 2 * out)
        return lw.Lowered(flops=n_chunks * block.flops,
                          bytes_accessed=n_chunks * block.bytes_accessed,
                          argument_bytes=fixed_dev, output_bytes=out, alias_bytes=0,
                          peak_bytes=peak, collectives=block.collectives * n_chunks,
                          host_bytes=host_bytes, window_bytes=window, n_blocks=n_chunks)


def offload(
    fn: Optional[Callable[..., Any]] = None,
    *,
    refs: Optional[Mapping[str, OffloadRef]] = None,
    device: DeviceLike = None,
    mesh=None,
) -> Any:
    """Decorate a function for offload to ``device`` (the card by default);
    arguments with a ``spec`` are placed on ``mesh`` (default: a
    ``("data",)`` mesh over the ranks)."""

    def wrap(f: Callable[..., Any]) -> OffloadedFunction:
        return OffloadedFunction(f, refs or {}, device, mesh)

    if fn is not None:
        return wrap(fn)
    return wrap
