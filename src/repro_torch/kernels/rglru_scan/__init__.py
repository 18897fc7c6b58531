from repro_torch.kernels.rglru_scan.ops import linear_recurrence
from repro_torch.kernels.rglru_scan.ref import linear_recurrence_ref

__all__ = ["linear_recurrence", "linear_recurrence_ref"]
