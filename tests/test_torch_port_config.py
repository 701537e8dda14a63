"""The port's config copy (`damc_tpu_torch/config.py`) against the JAX
package's presets, field for field."""

from __future__ import annotations

import dataclasses

import pytest

from damc_tpu.utils import config as jax_config
from damc_tpu_torch import config as port_config

PRESETS = ["cifar10", "cifar10-stable", "svhn", "celeba64", "celebaHQ", "mnist_anomaly", "toy"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax_field_for_field(name):
    want = dataclasses.asdict(jax_config.preset(name))
    got = dataclasses.asdict(port_config.preset(name))
    assert got == want


def test_section_fields_match_jax():
    for section in ("ModelConfig", "DiffusionConfig", "MCMCConfig", "OptimConfig", "TrainConfig", "Config"):
        want = [(f.name, f.type) for f in dataclasses.fields(getattr(jax_config, section))]
        got = [(f.name, f.type) for f in dataclasses.fields(getattr(port_config, section))]
        assert got == want, section


def test_unknown_preset_raises():
    with pytest.raises(ValueError):
        port_config.preset("imagenet")
