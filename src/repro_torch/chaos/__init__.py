"""repro_torch.chaos — the fault taxonomy with record/replay traces.

A copy of ``repro.chaos`` (numpy only); see :mod:`repro_torch.chaos.faults`.
"""
from .faults import (CAPACITY_LOSS, CHAOS_PROFILES, CKPT_CORRUPT,
                     DISK_FULL, FAULT_KINDS, HOST_CRASH, NAN_POISON,
                     NET_PARTITION, SERVE_KINDS, SLOWDOWN, SNAPSHOT_CORRUPT,
                     TRACE_VERSION, TRAIN_KINDS, ChaosEngine, FaultEvent,
                     FaultTrace, corrupt_checkpoint_shard, flip_bytes,
                     sample_trace)

__all__ = [
    "CAPACITY_LOSS", "CHAOS_PROFILES", "CKPT_CORRUPT", "ChaosEngine",
    "DISK_FULL", "FAULT_KINDS", "FaultEvent", "FaultTrace", "HOST_CRASH",
    "NAN_POISON", "NET_PARTITION", "SERVE_KINDS", "SLOWDOWN",
    "SNAPSHOT_CORRUPT", "TRACE_VERSION", "TRAIN_KINDS",
    "corrupt_checkpoint_shard", "flip_bytes", "sample_trace",
]
