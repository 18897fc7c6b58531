"""Offload argument annotations: pass-by-reference + prefetch specs (paper §3.1).

The paper's kernel annotation is::

    @offload(prefetch={a: {buffer_size:10, elements_per_prefetch:2,
                           distance:10, access:'ro'}})
    def mykernel(a, b): ...

``PrefetchSpec`` carries exactly those fields, with the JAX package's
validation; ``OffloadRef`` binds a kernel argument to a memory kind and an
optional prefetch spec.  These are pure declarations:
:mod:`repro_torch.core.offload` and the two streaming engines interpret them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core import memkind as mk

__all__ = ["Access", "PrefetchSpec", "OffloadRef", "AUTO", "ON_DEMAND"]

#: sentinel for runtime-tuned prefetch distance
AUTO = "auto"


class Access:
    READ_ONLY = "ro"
    READ_WRITE = "rw"


@dataclasses.dataclass(frozen=True)
class PrefetchSpec:
    """Paper §3.1: ``prefetch={variable, buffer_size, elements_per_prefetch,
    distance, access_modifier}``.

    Units are *chunks* of the streamed leading axis (KV blocks for the
    decode kernel):

    buffer_size
        number of chunks resident at once (ring depth).
    elements_per_fetch
        chunks moved per transfer.
    distance
        how many chunks ahead transfers are issued.  ``0`` is the paper's
        *on-demand* mode (fetch, then wait, at use time).  ``"auto"`` defers
        the choice: a fixed-shape ring resolves it through
        :func:`repro_torch.core.engine.static_auto_distance`.
    access
        ``'ro'`` — no write-back; ``'rw'`` — written chunks are copied back.
    """

    buffer_size: int = 2
    elements_per_fetch: int = 1
    distance: Union[int, str] = 1
    access: str = Access.READ_ONLY

    def __post_init__(self) -> None:
        if self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self.elements_per_fetch < 1:
            raise ValueError("elements_per_fetch must be >= 1")
        if isinstance(self.distance, str):
            if self.distance != AUTO:
                raise ValueError(f"distance must be an int >= 0 or 'auto', got {self.distance!r}")
        elif self.distance < 0:
            raise ValueError("distance must be >= 0")
        if self.access not in (Access.READ_ONLY, Access.READ_WRITE):
            raise ValueError(f"access must be 'ro' or 'rw', got {self.access!r}")
        if not self.is_auto and self.distance >= self.buffer_size + self.elements_per_fetch:
            raise ValueError(
                "distance must be < buffer_size + elements_per_fetch "
                f"(got distance={self.distance}, buffer_size={self.buffer_size})"
            )

    @property
    def is_auto(self) -> bool:
        return self.distance == AUTO

    @property
    def on_demand(self) -> bool:
        return self.distance == 0

    def numeric_distance(self, default: int = 1) -> int:
        """The static distance, with ``"auto"`` resolved to ``default``."""
        return default if self.is_auto else int(self.distance)


ON_DEMAND = PrefetchSpec(buffer_size=1, elements_per_fetch=1, distance=0)


@dataclasses.dataclass(frozen=True)
class OffloadRef:
    """Binds one kernel argument to a hierarchy level.

    The argument is passed to the device *by reference*: the kernel sees the
    data, but only chunk-sized pieces occupy device memory when ``kind`` is
    a host kind and ``prefetch`` streaming is active.  ``spec`` is the JAX
    package's partition spec (a tuple of mesh axis names, as
    :class:`~repro_torch.parallel.sharding.P`): the argument is placed by
    :func:`~repro_torch.core.memkind.sharding_for` on the function's mesh,
    each rank holding its shard; ``None`` places the whole tensor on the
    function's device, without a mesh.
    """

    kind: mk.MemKind = mk.DEVICE
    spec: Optional[tuple] = None
    prefetch: Optional[PrefetchSpec] = None
    #: leading axis that streaming chunks (None = bulk transfer, paper "eager")
    stream_axis: Optional[int] = 0

    def __post_init__(self) -> None:
        if self.prefetch is not None and self.kind.jax_kind == "device":
            raise ValueError(
                "prefetch streaming only applies to host-resident arguments; "
                "device-kind arguments are already at the fast tier"
            )

    @property
    def streamed(self) -> bool:
        return self.prefetch is not None and self.stream_axis is not None
