"""repro_torch.distributed — prefill and serve step factories."""
