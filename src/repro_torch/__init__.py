"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s subpackage layout.  It imports ``torch`` and
numpy and never ``jax`` or any ``repro`` module: framework-neutral code is
copied here.  The JAX package stays the reference the tests hold this one
against.

Ported so far: the CRCH workflow planner (``repro_torch.core``,
``repro_torch.launch.schedule``: features, PCA and the pairwise-distance
kernel on the card, the triplet merges, replicated HEFT, the checkpoint
interval, the runtime simulation, metrics, baselines, the DAX reader and
the MLP learner), and the continuous-batching serve path with CRCH request
replication (``repro_torch.launch.serve``) for olmo-1b, rwkv6-3b and
recurrentgemma-2b, and olmo-1b training under the fault-tolerant
coordinator with the pointer checkpoint store (``repro_torch.launch.train``,
``repro_torch.ft``, ``repro_torch.optim``, ``repro_torch.data``), on
hand-written CUDA kernels (``kernels/csrc``): pairwise distances for the
triplet clustering, GQA flash attention (causal or sliding-window) for
prefill and training and its backward, the WKV6 recurrence and the RG-LRU
scan.
"""
