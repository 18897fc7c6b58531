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
``decode_attention_paged``) carries decode; ``rglru_scan``
(``linear_recurrence``) carries the RG-LRU's recurrence in the hybrid's
prefill; ``streamed_matmul`` is the paper's prefetch ring one level down
(weights by reference, tiles streamed through shared memory).  Every TPU
kernel of the JAX package has its counterpart here.  ``flash_attention``
and ``streamed_matmul``'s bf16 route run on the tensor cores: ``wgmma`` fed
by TMA rings under mbarriers (``csrc/hopper.cuh``).  ``decode_attention``
splits the key axis across blocks and runs both products as ``mma.sync``,
merging the blocks' partials in a fixed order.
"""
