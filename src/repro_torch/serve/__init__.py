"""Serve front end: traffic generation and SLO scheduling.

Copies of the JAX package's ``repro.serve`` (numpy only, no JAX in it): an
open-loop load generator (:mod:`repro_torch.serve.loadgen`) and an
admission-controlled scheduler with per-request latency SLOs
(:mod:`repro_torch.serve.scheduler`) driving the paged
:class:`~repro_torch.launch.serve.ServeSession`.
"""
from repro_torch.serve.loadgen import LoadGenConfig, OfferedRequest, Phase, generate
from repro_torch.serve.scheduler import SLO, SLOScheduler

__all__ = [
    "LoadGenConfig",
    "OfferedRequest",
    "Phase",
    "generate",
    "SLO",
    "SLOScheduler",
]
