"""The port's pool3 InceptionV3 (`damc_tpu_torch/models/inception.py`)
against `damc_tpu/models/inception.py` on the CPU, at the real 299x299
input size.

Tolerances: features within relative L2 error 1e-4 of JAX's (float32
convolutions through 94 layers summed in other orders; measured on a
CPU: 4.1e-07 RGB, 2.6e-07 gray, 3.9e-07 from a fabricated state dict); the
resize alone within atol 1e-6, edges included."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.models import inception as jax_inception
from damc_tpu_torch.models import inception
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


REL_L2 = 1e-4


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def nets():
    """The JAX params and the port's module, both from init_random_params(seed=0)."""
    params_j = jax_inception.init_random_params(jax.random.PRNGKey(0), seed=0)
    return params_j, inception.InceptionPool3(inception.init_random_params(seed=0)).eval()


def test_init_random_params_draws_jax_numbers():
    a = jax_inception.init_random_params(jax.random.PRNGKey(0), seed=3)
    b = inception.init_random_params(seed=3)
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 28, 28, 1)], ids=["rgb", "gray"])
def test_pool3_matches_jax(nets, shape):
    params_j, net = nets
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax_inception.inception_pool3(params_j, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    err = rel_l2(got, want)
    print(f"pool3 {shape}: relative L2 error {err:.3e}")
    assert err <= REL_L2


def test_resize_matches_jax_edges_included():
    """32 -> 299 bilinear: pytorch-fid's F.interpolate(align_corners=False)
    against jax.image.resize, every pixel."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    got = inception.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()


def _pytorch_fid_state_dict(seed=4):
    """A state dict with pytorch-fid's key names (conv.weight OIHW and the
    four BatchNorm tensors of every BasicConv2d), with BN statistics away
    from the identity so that the folding is exercised."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, spec in inception.ARCH_SPEC.items():
        entries = {name: spec} if isinstance(spec, tuple) else {f"{name}.{s}": v for s, v in spec.items()}
        for full, (cin, cout, kh, kw) in entries.items():
            sd[f"{full}.conv.weight"] = torch.from_numpy(rng.randn(cout, cin, kh, kw).astype(np.float32) * 0.05)
            sd[f"{full}.bn.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
            sd[f"{full}.bn.bias"] = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
            sd[f"{full}.bn.running_mean"] = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
            sd[f"{full}.bn.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
            sd[f"{full}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"] = torch.zeros(1008, 2048)  # pytorch-fid's head, unused by pool3
    return sd


def test_weights_from_the_env_var_load_into_both_packages(tmp_path, monkeypatch):
    path = tmp_path / "pt_inception.pth"
    torch.save(_pytorch_fid_state_dict(), path)
    monkeypatch.setenv(inception.WEIGHTS_ENV_VAR, str(path))
    assert inception.WEIGHTS_ENV_VAR == jax_inception.WEIGHTS_ENV_VAR
    jfn = jax_inception.try_load_inception_feature_fn()
    pfn = inception.try_load_inception_feature_fn(device="cpu")
    assert jfn is not None and pfn is not None
    x = np.random.default_rng(5).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = pfn(torch.from_numpy(x)).numpy()
    err = rel_l2(got, want)
    print(f"pool3 from a pytorch-fid state dict: relative L2 error {err:.3e}")
    assert err <= REL_L2
    monkeypatch.setenv(inception.WEIGHTS_ENV_VAR, str(tmp_path / "missing.pth"))
    monkeypatch.setattr(inception, "DEFAULT_WEIGHTS_PATHS", ())
    assert inception.try_load_inception_feature_fn(device="cpu") is None
