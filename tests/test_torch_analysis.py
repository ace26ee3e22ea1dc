"""The port's analytic FLOP model and input shapes against the JAX
package's: ``cell_flops`` equal in every field for the ten configs (and
their tiny configs) at every assigned shape, ``input_specs`` with JAX's
shapes and dtypes (tensors on the ``meta`` device), ``cell_supported``
equal, and ``make_batch`` equal element for element at the same seed.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import flops as JF  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro_torch.analysis import flops as F  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

DTYPES = {"int32": torch.int32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
CASES = [(arch, tiny) for arch in ARCHS for tiny in (False, True)]


@pytest.mark.parametrize("arch,tiny", CASES)
def test_cell_flops_equal_jax_in_every_field(arch, tiny):
    cfg, jcfg = get_config(arch, tiny=tiny), jax_get_config(arch, tiny=tiny)
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        got, want = F.cell_flops(cfg, shape), JF.cell_flops(jcfg, jshape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert (shapes.cell_supported(cfg, shape)
                == jshapes.cell_supported(jcfg, jshape)), name
    # the train multiplier and the remat convention are the same numbers
    assert F.TRAIN_MULT_MATMUL == JF.TRAIN_MULT_MATMUL
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC


def _spec_leaves(tree):
    return [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in flatten(tree)]


def _jax_spec_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(k.key for k in path), tuple(s.shape), str(s.dtype))
            for path, s in flat]


@pytest.mark.parametrize("arch,tiny", CASES)
def test_input_specs_have_jax_shapes_and_dtypes(arch, tiny):
    cfg, jcfg = get_config(arch, tiny=tiny), jax_get_config(arch, tiny=tiny)
    for name, shape in shapes.SHAPES.items():
        if tiny and shape.kind == "decode":
            shape = dataclasses.replace(shape, seq_len=64, global_batch=2)
        jshape = jshapes.Shape(**dataclasses.asdict(shape))
        got = shapes.input_specs(cfg, shape)
        assert all(t.device.type == "meta" for _, t in flatten(got))
        assert _spec_leaves(got) == _jax_spec_leaves(
            jshapes.input_specs(jcfg, jshape)), name


@pytest.mark.parametrize("arch", ["olmo_1b", "whisper_small",
                                  "llava_next_mistral_7b"])
@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_equals_jax(arch, seed):
    cfg, jcfg = get_config(arch, tiny=True), jax_get_config(arch, tiny=True)
    got = shapes.make_batch(cfg, batch=2, seq=16, seed=seed)
    want = jshapes.make_batch(jcfg, batch=2, seq=16, seed=seed)
    assert got.keys() == want.keys()
    for k, w in want.items():
        t = got[k]
        assert t.dtype == DTYPES[str(w.dtype)], k
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16)), k
        else:
            assert np.array_equal(t.numpy(), np.asarray(w)), k
