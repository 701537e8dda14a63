"""Channel parallelism (`damc_tpu_torch/parallel/tp.py`) on the CPU: the
policy against JAX's `channel_sharding_tree`, and a channel-sharded
StyleGAN synthesis on 2 gloo ranks (`torch_port_gloo.GlooGroup`, one
group for the module) against the replicated one.

  * The leaves the port shards are the leaves JAX shards, on the same
    weights (the port's seeded random StyleGAN generator and encoder at
    resolution 32, carried into JAX through its own converters), over a
    `model` axis of 2. A leaf is named by its sorted values, which the
    layouts (OIHW and HWIO, (1, C, 4, 4) and (4, 4, C)) do not change.
  * The resolution-32 synthesis with its wide parameters sharded over 2
    ranks: the image and the gradients of its sum of squares with respect
    to the W+ codes and to every parameter (the sharded ones gathered)
    within JAX's own test limits for the sharded synthesis (rtol 1e-4,
    atol 1e-5), and each rank holds about half of the parameters.
"""

from __future__ import annotations

import hashlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_gloo as gloo
from damc_tpu.models import stylegan as jsg
from damc_tpu.parallel import channel_sharding_tree as jax_channel_sharding_tree
from damc_tpu.parallel import make_mesh as jax_make_mesh
from damc_tpu_torch.models.stylegan import build_stylegan, num_synthesis_layers
from damc_tpu_torch.parallel import Mesh, channel_sharding_spec, channel_sharding_tree
from torch_port_helpers import one_torch_thread

RES, SEED, MIN_CHANNELS = 32, 3, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def _key(a) -> str:
    return hashlib.sha256(np.sort(np.asarray(a, np.float32).ravel()).tobytes()).hexdigest()


def test_policy_shards_the_leaves_jax_shards():
    nets = build_stylegan(RES, seed=SEED, device="cpu")
    mesh = Mesh(rank=0, world=2, device=torch.device("cpu"))
    jmesh = jax_make_mesh(n_data=1, n_model=2)
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    for module, convert in ((nets.generator, jsg.convert_generator_state_dict),
                            (nets.encoder, jsg.convert_encoder_state_dict)):
        params = convert(sd(module), RES)
        shardings = jax_channel_sharding_tree(jmesh, params, MIN_CHANNELS)
        leaves = jax.tree_util.tree_leaves(params)
        specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda s: hasattr(s, "spec"))
        want = {_key(x) for x, s in zip(leaves, specs) if s.spec != P()}
        tree = channel_sharding_tree(mesh, module, MIN_CHANNELS)
        named = dict(module.named_parameters())
        got = {_key(named[n].detach()) for n, dim in tree.items() if dim is not None}
        assert len(want) > 10 and got == want
        # Nothing is sharded over one rank, or below min_channels.
        assert not any(channel_sharding_tree(Mesh(0, 1, torch.device("cpu")), module, MIN_CHANNELS).values())
    leaf = channel_sharding_spec(mesh, MIN_CHANNELS)
    assert leaf(torch.zeros(64, 3)) == 0 and leaf(torch.zeros(3, 3, 8, 128), 3) == 3
    assert leaf(torch.zeros(32, 3)) is None and leaf(torch.zeros(128)) is None
    assert channel_sharding_spec(Mesh(0, 3, torch.device("cpu")), MIN_CHANNELS)(torch.zeros(64, 3)) is None


def test_sharded_synthesis_matches_replicated_forward_and_gradient(group):
    wp = np.random.RandomState(0).randn(2, num_synthesis_layers(RES) * 512).astype(np.float32)
    results = group(2).run(gloo.tp_synthesis, RES, SEED, wp, MIN_CHANNELS)
    gen = build_stylegan(RES, seed=SEED, device="cpu").generator.requires_grad_(True)
    x = torch.from_numpy(wp).requires_grad_(True)
    img = gen(x)
    (img**2).sum().backward()
    total = sum(p.numel() for p in gen.parameters())
    sharded_elems = 0
    for tree, got_img, got_dx, grads, held in results:
        assert set(grads) == {n for n, _ in gen.named_parameters()}
        np.testing.assert_allclose(got_img, img.detach().numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_dx, x.grad.numpy(), rtol=1e-4, atol=1e-5)
        for name, p in gen.named_parameters():
            if p.grad is None:  # read by no forward here: the mapping network, the lower toRGBs
                assert grads[name] is None and name.startswith(("mapping.", "synthesis.output")), name
            else:
                np.testing.assert_allclose(grads[name], p.grad.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
        sharded_elems = sum(p.numel() for n, p in gen.named_parameters() if tree[n] is not None)
        assert held == total - sharded_elems // 2
    assert results[0][0] == results[1][0] and sharded_elems > 0.9 * total
