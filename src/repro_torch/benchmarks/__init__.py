"""The paper's benchmarks on the port (``python -m repro_torch.benchmarks.<name>``)."""
