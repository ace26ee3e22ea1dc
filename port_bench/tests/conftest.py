"""CPU tests of the benchmark harness (``python -m pytest port_bench/tests``
from the root of the checkout; the card tests, marked ``cuda``, skip
without a card)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the cells' sizes cut for the CPU (widths too: these runs check the
#: harness's paths and arithmetic, never the cells' numbers)
TINY = {
    "olmo1b-train-8x2048": dict(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=4, d_ff=128, vocab_size=256),
    "granitemoe1b-train-8x2048": dict(n_layers=2, d_model=64, n_heads=4,
                                      n_kv_heads=2, d_ff=64, vocab_size=256,
                                      n_experts=4, top_k=2),
}
TINY_TRAFFIC = {"batch": 4, "seq_len": 64}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
