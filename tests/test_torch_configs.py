"""The port's architecture registry against the JAX package's:
``configs.all_configs(tiny=)`` gives the same keys as JAX's, in JAX's order,
and every config equal field by field, published and tiny."""
import dataclasses

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import all_configs as jax_all_configs
from repro_torch.configs import ARCHS, all_configs, get_config


@pytest.mark.parametrize("tiny", [False, True])
def test_all_configs_equals_jax_field_by_field(tiny):
    want = jax_all_configs(tiny=tiny)
    got = all_configs(tiny=tiny)
    assert list(got) == list(want) == list(JAX_ARCHS) == list(ARCHS)
    for name, cfg in got.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[name]), name
        assert cfg == get_config(name, tiny=tiny)
