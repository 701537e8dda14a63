"""The port's StyleGAN stack (`damc_tpu_torch/models/stylegan.py`) against
the JAX package's pure functions on the CPU.

The JAX StyleGAN tests compare JAX with the reference torch modules, which
this repository does not ship. These tests need no reference: the port's
modules are built with random weights (`build_stylegan`), their state
dicts go through JAX's own `convert_*_state_dict` (the converters of the
published `.pth` files), and the two forwards are held together on the
same inputs at `tests/test_stylegan.py`'s tolerances: synthesis atol 5e-3
(:81), mapping and truncation atol 2e-5 (:95-97), the fused up-conv block
atol 1e-4 (:129), the encoder atol 3e-4 (:169), VGG16 atol 2e-2 / rtol 1e-4
(:186). Port modules run NCHW; JAX's NHWC."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.models import stylegan as jsg
from damc_tpu.utils.flops import inversion_phase_flops as jax_inversion_flops
from damc_tpu_torch.convert import stylegan_state_dicts_from_jax
from damc_tpu_torch.models.stylegan import (
    AUTO_FUSED_MIN_RES, VGG16Features, W_DIM, _UpConvBlock, build_stylegan, generator_apply, init_random_,
    load_stylegan, num_synthesis_layers, sample_w_codes,
)
from damc_tpu_torch.utils.flops import inversion_phase_flops
from torch_port_helpers import one_torch_thread

RES = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def nets():
    return build_stylegan(RES, seed=0, device="cpu")


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def test_synthesis_matches_jax(nets):
    params = jsg.convert_generator_state_dict(_np_sd(nets.generator), RES)
    wp = np.random.RandomState(0).randn(2, num_synthesis_layers(RES) * W_DIM).astype(np.float32)
    want = jsg.generator_apply(params, jnp.asarray(wp), RES)
    with torch.no_grad():
        got = generator_apply(nets.generator, torch.from_numpy(wp))
    assert got.shape == (2, 3, RES, RES)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=5e-3)


def test_mapping_truncation_and_w_codes_match_jax(nets):
    params = jsg.convert_generator_state_dict(_np_sd(nets.generator), RES)
    z = np.random.RandomState(1).randn(3, W_DIM).astype(np.float32)
    w_j = jsg.mapping_apply(params["mapping"], jnp.asarray(z))
    wp_j = jsg.truncation_apply(params["truncation"], w_j, RES)
    with torch.no_grad():
        w_p = nets.generator.mapping(torch.from_numpy(z))
        wp_p = nets.generator.truncation(w_p)
        codes = sample_w_codes(nets.generator, torch.from_numpy(z))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), atol=2e-5)
    np.testing.assert_allclose(wp_p.numpy(), np.asarray(wp_j), atol=2e-5)
    assert codes.shape == (3, num_synthesis_layers(RES) * W_DIM)
    np.testing.assert_allclose(codes.numpy(), np.asarray(wp_j).reshape(3, -1), atol=2e-5)


def test_fused_upconv_block_matches_jax():
    """The padded-kernel fold and stride-2 transposed convolution of the
    res >= 128 blocks, alone at 6 -> 4 channels (res 32 never reaches it),
    against JAX's `_up_conv_block(fused=True)`."""
    blk = _UpConvBlock(AUTO_FUSED_MIN_RES, 6, 4)
    blk.epilogue.apply_noise.noise = torch.zeros(1, 1, 8, 8)  # the block's output here is 8x8
    blk = init_random_(blk, torch.Generator().manual_seed(2)).eval()
    assert blk.fused
    sd = _np_sd(blk)
    assert sd["weight"].shape == (3, 3, 6, 4)
    p = {
        "weight": jnp.asarray(sd["weight"]),
        "epilogue": {
            "noise": jnp.asarray(sd["epilogue.apply_noise.noise"][0, 0]),
            "noise_weight": jnp.asarray(sd["epilogue.apply_noise.weight"]),
            "bias": jnp.asarray(sd["epilogue.bias"]),
            "style_mod": {"dense": {
                "weight": jnp.asarray(sd["epilogue.style_mod.dense.fc.weight"]),
                "bias": jnp.asarray(sd["epilogue.style_mod.dense.wscale.bias"]),
            }},
        },
    }
    x = np.random.RandomState(3).randn(2, 6, 4, 4).astype(np.float32)
    w = np.random.RandomState(4).randn(2, W_DIM).astype(np.float32)
    want = jsg._up_conv_block(p, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), fused=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)


def test_encoder_matches_jax(nets):
    """BN in inference mode from running statistics, in train mode too."""
    params = jsg.convert_encoder_state_dict(_np_sd(nets.encoder), RES)
    x = np.random.RandomState(7).uniform(-1, 1, (2, 3, RES, RES)).astype(np.float32)
    want = jsg.encoder_apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), RES)
    with torch.no_grad():
        got = nets.encoder(torch.from_numpy(x))
        in_train_mode = nets.encoder.train()(torch.from_numpy(x))
    nets.encoder.eval()
    assert got.shape == (2, num_synthesis_layers(RES) * W_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4)
    assert torch.equal(in_train_mode, got)


def test_vgg16_matches_jax(nets):
    params = jsg.convert_vgg16_state_dict(_np_sd(nets.vgg))
    assert len(params) == 10
    x = np.random.RandomState(9).rand(1, 3, RES, RES).astype(np.float32) * 2 - 1
    want = jsg.vgg16_features(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = nets.vgg(torch.from_numpy(x))
    assert got.shape == (1, 512, RES // 8, RES // 8)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-2, rtol=1e-4)


def test_frozen_and_reference_keys(nets):
    """No parameter requires grad, every module is in eval mode, and the
    state dicts hold exactly the keys JAX's converters read: the converted
    trees map back to the same tensors (`convert.py`)."""
    for m in (nets.generator, nets.encoder, nets.vgg):
        assert not m.training and not any(p.requires_grad for p in m.parameters())
    trees = {
        "generator": jsg.convert_generator_state_dict(_np_sd(nets.generator), RES),
        "encoder": jsg.convert_encoder_state_dict(_np_sd(nets.encoder), RES),
        "vgg": jsg.convert_vgg16_state_dict(_np_sd(nets.vgg)),
    }
    back = stylegan_state_dicts_from_jax(trees, RES)
    for name in trees:
        sd = getattr(nets, name).state_dict()
        assert set(back[name]) == set(sd), name
        assert all(torch.equal(back[name][k], sd[k]) for k in sd), name


def test_load_stylegan_takes_the_converter_keys(nets, tmp_path, capsys):
    """A `.pth` with an extra key (as the published ones hold: blur
    kernels, `lod`) loads, naming the key it did not take; a missing key
    raises."""
    paths = {}
    for name in ("generator", "encoder", "vgg"):
        sd = dict(getattr(nets, name).state_dict())
        sd["extra.lod"] = torch.zeros(())
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(sd, paths[name])
    loaded = load_stylegan(paths["generator"], paths["encoder"], paths["vgg"], RES, device="cpu")
    out = capsys.readouterr().out
    assert out.count("keys not taken: extra.lod") == 3
    for name in ("generator", "encoder", "vgg"):
        a, b = getattr(loaded, name).state_dict(), getattr(nets, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b)
        assert not getattr(loaded, name).training
    sd = dict(nets.vgg.state_dict())
    del sd["layer21.bias"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="layer21.bias"):
        load_stylegan(vgg_path=str(tmp_path / "short.pth"), device="cpu")
    assert load_stylegan(device="cpu").generator is None
    assert isinstance(VGG16Features(), torch.nn.Module)


@pytest.mark.parametrize("res", [32, 256])
def test_inversion_flops_match_jax(res):
    """The port's copy of the FLOPs model equals JAX's, part by part (JAX's
    `sweep` holds the encoder); at 256^2 and B=8 about 1.33e14 FLOP."""
    got = inversion_phase_flops(8, res)
    want = jax_inversion_flops(8, res)
    assert got["encoder"] + got["sweep"] == pytest.approx(want["sweep"], rel=1e-12)
    for k in ("feat_x", "adam", "rescue_final", "total"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    if res == 256:
        assert 1.3e14 < got["total"] < 1.36e14
