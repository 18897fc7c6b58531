"""Hardware constants for the roofline model.

``HwSpec`` has the JAX package's fields and names.  ``H100`` is the card
the port runs on; ``V5E`` is the JAX package's constant, kept so that its
Table-1 row can still be printed as it cites it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float  # FLOP/s per chip
    hbm_bw: float  # bytes/s per chip
    ici_bw: float  # bytes/s per link
    hbm_bytes: float  # capacity per chip


#: NVIDIA H100 SXM (data sheet, dense rates at the 700 W limit): 989 TFLOP/s
#: bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB; NVLink 4 gives
#: 900 GB/s over 18 links, 50 GB/s a link
H100 = HwSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw=50e9,
    hbm_bytes=80 * 2**30,
)

#: the JAX package's TPU v5e (its roofline target), as it cites it
V5E = HwSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 2**30,
)
