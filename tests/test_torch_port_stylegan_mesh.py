"""The data-parallel StyleGAN inversion eval (`train/stylegan_inv.py::
evaluate_inversion(mesh=)`, `cli/eval_stylegan_inv.py --use_mesh`) on 2
gloo ranks (`torch_port_gloo.GlooGroup`, one group for the module) against
the port's world of 1, at resolution 32 (nz = 8 x 512 = 4096, a 147M-weight
Q), with seeded random networks and Q's Fourier matrix damped by 100 as in
tests/test_torch_port_stylegan_inv.py (at nz 4096 the unit-normal one
makes the float32 sweep chaotic).

5 images in batches of 4: the tail batch holds 1 image and 3 copies of
it, so rank 1 holds only padding there and must still take part in the
reductions. Each rank inverts its 2 rows of every batch from its rows of
the global batch's draws, so the recon MSE agrees with world 1 at rtol
1e-5 and the Frechet distance of the reconstructions (the random feature
map) at rtol 1e-4: the convolutions and products run at 2 rows where world
1 runs 4, and the float64 statistics are summed in another order. A batch
that does not divide over the ranks raises.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_port_gloo as gloo
from torch_port_helpers import one_torch_thread

RES, SEED, BATCH, STEPS, DAMP = 32, 4, 4, 2, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def test_two_rank_inversion_eval_matches_world_one(group):
    images = np.random.RandomState(2).uniform(-1, 1, (5, RES, RES, 3)).astype(np.float32)
    (out0, raised0), (out1, raised1) = group(2).run(gloo.inversion_eval, RES, SEED, images, BATCH, STEPS, DAMP)
    want, _ = gloo.inversion_eval(RES, SEED, images, BATCH, STEPS, DAMP, world_one=True)
    assert out0 == out1 and raised0 and raised1
    assert set(out0) == set(want) == {"recon_mse", "frechet_rand"}
    assert all(np.isfinite(v) for v in out0.values())
    np.testing.assert_allclose(out0["recon_mse"], want["recon_mse"], rtol=1e-5)
    np.testing.assert_allclose(out0["frechet_rand"], want["frechet_rand"], rtol=1e-4)
