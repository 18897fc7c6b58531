"""The roofline model: hardware constants (``hw.HwSpec``: the H100 the port
runs on, and the JAX package's TPU v5e kept as it cites it), the analytic
terms of a step and the HLO collective parser (``analysis``), and the
tables over a rows JSON (``report``)."""
from repro_torch.roofline.analysis import (
    RooflineResult,
    analytic_hbm_bytes,
    collective_bytes_from_hlo,
    cost_terms,
    model_flops,
    residual_inner_scan_flops,
    roofline_report,
    weighted_collective_bytes,
)
from repro_torch.roofline.hw import H100, V5E, HwSpec

__all__ = ["H100", "V5E", "HwSpec", "RooflineResult", "analytic_hbm_bytes",
           "collective_bytes_from_hlo", "cost_terms", "model_flops",
           "residual_inner_scan_flops", "roofline_report", "weighted_collective_bytes"]
