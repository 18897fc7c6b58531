from repro_torch.kernels.streamed_matmul.ops import streamed_matmul
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

__all__ = ["streamed_matmul", "matmul_ref"]
