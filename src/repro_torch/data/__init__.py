from repro_torch.data.loader import DiskShardLoader, PrefetchLoader
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch

__all__ = ["synthetic_batch", "SyntheticConfig", "PrefetchLoader", "DiskShardLoader"]
