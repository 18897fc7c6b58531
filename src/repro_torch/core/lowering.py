"""Lower a step on the meta device: the port's ``jit(fn).lower(*args).compile()``.

The JAX package's dry-run lowers a step against abstract arguments and
reads XLA's analyses of the compiled module.  The port has no compiler
between a step and the card, so :func:`lower` runs the step once, eagerly,
on meta tensors (shapes and dtypes: no memory is allocated and no kernel
runs), under a dispatch mode that sees every aten op.  Under a mesh the
arguments are DTensors over the process group that is up, real or
``init_process_group("fake", ...)`` (shape-only ranks in one process, the
counterpart of the JAX package's placeholder devices).  DTensor derives
each op's global output shape on fake tensors; those ops are not counted.
What the mode counts are the local ops one rank runs: its shards, the work
it repeats on replicated values, and its collectives, as XLA's SPMD module
counts them.

A :class:`Compiled` reports, per device:

``cost_analysis()``
    ``flops``: the products' FLOPs by ``torch.utils.flop_counter``'s rules
    (matmuls, convolutions, attention); element-wise work counts nothing,
    where XLA's CPU cost model adds one per element, so the port's count is
    the lower.  ``bytes accessed``: the operand and output bytes of every
    aten op that is not a view, at full tensor width (XLA's definition).
``memory_analysis()``
    the five fields of XLA's: the arguments' local bytes, the outputs',
    the donated arguments the outputs replace (``alias``), no generated
    code, and ``temp`` such that ``argument + output + temp - alias`` is
    the peak of live bytes the step held (a storage is live from the op
    that made it until it is freed).  An eager step donates nothing: where
    it holds the old and the new state together, that is its peak.
``as_text()``
    one line a collective in the HLO form ``name = dtype[dims] op(...)``,
    with the local shard's shape, which
    :func:`repro_torch.roofline.analysis.collective_bytes_from_hlo` reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Iterable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tree as tr

__all__ = ["Compiled", "Lowered", "MemoryAnalysis", "lower", "meta_like", "tensor_bytes",
           "time_limit"]

#: ``time.monotonic()`` past which a lowering stops (:func:`time_limit`)
_DEADLINE: list = [None]

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128", torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

#: functional collectives by HLO op class (a one-source broadcast is a
#: point-to-point copy to every rank, XLA's collective-permute)
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

#: ops that move no bytes (allocation, aliasing, autograd bookkeeping)
_NO_DATA = {"empty", "empty_strided", "empty_like", "detach", "lift_fresh", "alias",
            "_unsafe_view", "wait_tensor", "_wrap_tensor_autograd", "set_"}


def _flat(x: Any, out: list) -> list:
    """The tensors of an op's arguments or results (lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _local(x: Any) -> Any:
    """The local shard of a DTensor; any other value as it is."""
    return x.to_local() if hasattr(x, "placements") and hasattr(x, "to_local") else x


def _tensors(tree: Any) -> list:
    return [t for t in (_local(x) for x in tr.leaves(tree)) if isinstance(t, torch.Tensor)]


def tensor_bytes(tree: Any) -> int:
    """Bytes of the distinct storages ``tree``'s tensors (a DTensor's local
    shard) hold."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())


def meta_like(tree: Any) -> Any:
    """``tree`` with each tensor or numpy array replaced by an uninitialised
    meta tensor of its shape and dtype (a DTensor or a meta tensor stays)."""
    import numpy as np

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x if x.is_meta or hasattr(x, "placements") else torch.empty(
                x.shape, dtype=x.dtype, device="meta")
        if isinstance(x, np.ndarray) or hasattr(x, "dtype") and hasattr(x, "shape"):
            dtype = torch.from_numpy(np.empty((), dtype=np.dtype(x.dtype))).dtype
            return torch.empty(tuple(x.shape), dtype=dtype, device="meta")
        return x

    return tr.tree_map(leaf, tree)


@contextlib.contextmanager
def time_limit(seconds: float):
    """Stop any :func:`lower` inside the block that runs past ``seconds`` of
    wall time with a ``TimeoutError`` (0: no limit)."""
    prev = _DEADLINE[0]
    _DEADLINE[0] = time.monotonic() + seconds if seconds else None
    try:
        yield
    finally:
        _DEADLINE[0] = prev


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """XLA's ``memory_analysis()`` fields, per device, in bytes."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    generated_code_size_in_bytes: int = 0


class _Counter(TorchDispatchMode):
    """Counts the local ops a step runs: FLOPs, bytes accessed, the live
    bytes of the storages it makes on the meta device (and their peak), and
    its collectives."""

    def __init__(self, live0: int, known: Iterable) -> None:
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.live = self.peak = live0
        self.collectives: list[tuple[str, torch.dtype, tuple]] = []
        self.n_ops = 0
        self._known: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
        for s in known:
            self._known[id(s)] = s

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        s = t.untyped_storage()
        if self._known.get(id(s)) is s:
            return
        self._known[id(s)] = s
        n = s.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # a DTensor op: its local ops come back through here
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's shape propagation, not a device's work
        outs = _flat(out, [])
        ins = _flat((args, kwargs), [])
        if not any(t.device.type == "meta" for t in ins + outs):
            return out  # DTensor's index arithmetic on the host, not the step's
        name = func._schema.name.split("::")
        op = name[-1]
        self.n_ops += 1
        if not self.n_ops % 1024 and _DEADLINE[0] is not None and time.monotonic() > _DEADLINE[0]:
            raise TimeoutError(f"the lowering ran past its time limit ({self.n_ops} ops counted)")
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs, out_val=out))
        if op in _COLLECTIVES and name[0] in _COLLECTIVE_NAMESPACES:
            self.collectives += [(_COLLECTIVES[op], o.dtype, tuple(o.shape)) for o in outs]
        if not func.is_view and op not in _NO_DATA:
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for o in outs:
            self._track(o)
        return out


@dataclasses.dataclass
class Compiled:
    """What a lowered step reports (see the module docstring); every count
    is one device's."""

    flops: int
    bytes_accessed: int
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int
    collectives: list = dataclasses.field(default_factory=list)
    #: ``OffloadedFunction.lower``: bytes of the arguments homed at a host
    #: kind, the device bytes of a streamed call's ring, and its blocks
    host_bytes: int = 0
    window_bytes: int = 0
    n_blocks: int = 1

    def cost_analysis(self) -> dict[str, float]:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed)}

    def memory_analysis(self) -> MemoryAnalysis:
        temp = self.peak_bytes - self.argument_bytes - self.output_bytes + self.alias_bytes
        return MemoryAnalysis(self.argument_bytes, self.output_bytes, max(temp, 0),
                              self.alias_bytes)

    def as_text(self) -> str:
        return "\n".join(
            f"%{op.replace('-', '_')}.{i} = {_HLO_DTYPE.get(dt, str(dt))}"
            f"[{','.join(map(str, shape))}] {op}(...)"
            for i, (op, dt, shape) in enumerate(self.collectives))


class Lowered(Compiled):
    """A traced step; :meth:`compile` gives its :class:`Compiled` (the
    trace is the whole of the work, so nothing is left to compile)."""

    def compile(self) -> Compiled:
        return Compiled(**{f.name: getattr(self, f.name) for f in dataclasses.fields(Compiled)})


def lower(fn: Callable[..., Any], *args: Any, donate_argnums: Sequence[int] = (),
          **kwargs: Any) -> Lowered:
    """Run ``fn(*args, **kwargs)`` once on meta tensors (or DTensors of meta
    shards) and count it.  ``donate_argnums``: the arguments the outputs
    replace (the JAX package's ``jax.jit(donate_argnums=...)``), whose
    bytes are the ``alias``.  The arguments are held for the whole call, as
    a caller holds them."""
    arg_tensors = _tensors((args, kwargs))
    if any(t.device.type != "meta" for t in arg_tensors):
        raise ValueError("lower() takes meta tensors (meta_like() makes them)")
    argument = tensor_bytes((args, kwargs))
    alias = tensor_bytes([args[i] for i in donate_argnums])
    counter = _Counter(argument, (t.untyped_storage() for t in arg_tensors))
    with counter:
        out = fn(*args, **kwargs)
    lowered = Lowered(flops=counter.flops, bytes_accessed=counter.bytes_accessed,
                      argument_bytes=argument, output_bytes=tensor_bytes(out),
                      alias_bytes=alias, peak_bytes=counter.peak,
                      collectives=counter.collectives)
    del out
    return lowered
