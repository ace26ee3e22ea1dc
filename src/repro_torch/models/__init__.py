"""repro_torch.models — the dense decoder family (olmo-1b) in PyTorch."""
