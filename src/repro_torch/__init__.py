"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
subpackage layout (``configs``, ``core``, ``models``, ``kernels``, ``train``,
``launch``) and imports neither JAX nor anything of ``repro``.  The TPU's
Pallas kernels become CUDA C++ kernels for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use (``kernels/_build.py``) and bound with ``ctypes``.

Entry points run on the card; the CPU is used only when the caller passes
``device="cpu"`` (the parity tests do), and then each kernel wrapper runs its
plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
