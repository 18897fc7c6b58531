from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.runtime.elastic import elastic_mesh_shape
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["TrainDriver", "DriverConfig", "elastic_mesh_shape", "StragglerMonitor"]
