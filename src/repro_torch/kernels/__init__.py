"""Hand-written Hopper kernels for the serving hot spots.

Each kernel is a subpackage with:
  ``ops.py``  the wrapper: checks device, dtype, shape and contiguity,
              allocates outputs, launches the CUDA kernel on the current
              stream and counts its launches; on a CPU tensor it runs the
              plain version instead (never on a CUDA tensor),
  ``ref.py``  the plain PyTorch version, used by the CPU tests and by
              ``chip_smoke.py`` to check the kernel on the card.

The CUDA sources are in ``repro_torch/csrc/``; ``_build.py`` compiles them
with ``nvcc`` for ``sm_90a`` at first use and binds them with ``ctypes``.

``flash_attention`` carries prefill and ``decode_attention`` (with
``decode_attention_paged``) carries decode; ``streamed_matmul`` is the
paper's prefetch ring one level down (weights by reference, tiles streamed
through shared memory).  The JAX package's fourth TPU kernel,
``rglru_scan``, is not ported yet (ROADMAP.md).
"""
