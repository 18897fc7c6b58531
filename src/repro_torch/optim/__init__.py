from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.grad_compress import pod_allreduce_int8
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "grad_compress",
           "pod_allreduce_int8"]
