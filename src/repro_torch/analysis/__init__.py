"""repro_torch.analysis — analytic FLOP and HBM-byte accounting per
(architecture x shape) cell (counterpart of ``repro.analysis``; the HLO
collective parser waits for the port's sharding slice)."""
from . import flops  # noqa: F401
