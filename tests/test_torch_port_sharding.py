"""K4a and K4b, the sharded kernels (`fused_prior_langevin_sharded`,
`fused_reverse_sweep_sharded`), and the process-group layer on the CPU.

The ranks are gloo processes (`torch_port_gloo.GlooGroup`, one group of 2
and one of 4 for the module). Each rank takes its rows of the global batch
and runs the plain version with `row_base` its first global row; the rows
are gathered. Held:

  * the stream seeds' layout as a pure function: the b rows from
    `row_base` on are those rows of the unsharded seeds (hypothesis);
  * the gathered result against the unsharded plain version in stream,
    counter and noiseless mode, at atol 1e-6: torch.matmul may sum a row
    in another order at another batch size, so the CPU's plain versions
    are not held bit for bit across batch sizes (the card's kernels are:
    a row's summation order is fixed there, and chip_smoke.py holds them
    bit for bit);
  * in counter mode, against the JAX package's sharded kernels on meshes of
    2 and 4 of the 8 virtual CPU devices (tests/conftest.py), run as
    tests/test_pallas_sharding.py runs them (plain interpreter), at the
    unsharded comparisons' limits: K1 atol 1e-5 (tests/
    test_torch_port_langevin.py), K2 atol 2e-4 and rtol 1e-4 at 6 steps
    (tests/test_torch_port_qsweep.py);
  * a world of 1 launches K1 or K2 alone, with no collective;
  * the transport is never switched: nccl on the CPU, and nccl with two
    ranks on one card, raise naming gloo.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_port_gloo as gloo
from damc_tpu.ops.pallas.fused_langevin import fused_prior_langevin_sharded as jax_k4a
from damc_tpu.ops.pallas.fused_qsweep import fused_reverse_sweep_sharded as jax_k4b
from damc_tpu.ops.pallas.fused_qsweep import step_coefficients as jax_coeffs
from damc_tpu.parallel import make_mesh as jax_make_mesh
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from damc_tpu_torch.ops.cuda import fused_qsweep as k2
from damc_tpu_torch.ops.noise import stream_row_seeds
from damc_tpu_torch.parallel import Mesh
from damc_tpu_torch.parallel import distributed as pd

NZ, NDF = 16, 32  # K1 widths (nz a multiple of 4, ndf of 4)
K2_DINS = [2 * NZ, 16, 32, 32, 64, 64, 32]  # the U-Net at narrow widths: 3 in, 1 mid, 3 out
K2_DOUTS = [16, 32, 32, 32, 32, 16, NZ]
MODES = ["stream", "counter", "noiseless"]


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def _k1_inputs(b: int, seed: int):
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    w = [u((NZ, NDF), NZ), u((NDF,), NZ), u((NDF, NDF), NDF), u((NDF,), NDF), u((NDF,), NDF)]
    return r.normal(size=(b, NZ)).astype(np.float32), w, r.integers(-2**31, 2**31 - 1, b).astype(np.int32)


def _k2_inputs(b: int, n: int, seed: int, scale: float = 0.5):
    """As tests/test_torch_port_qsweep.py's, at narrow widths: layers at
    half the torch-default scale (six steps of full-scale random weights
    amplify float32 rounding past any fp32 pair's limit)."""
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (scale * r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    fourier = r.normal(size=(NZ, NZ // 2)).astype(np.float32)
    layers = [(u((i, o), i), u((o,), i), u((i, o), i), u((o,), i), u((o, o), o), u((o,), o), u((o, o), o))
              for i, o in zip(K2_DINS, K2_DOUTS)]
    pre_x = [r.normal(size=(b, o)).astype(np.float32) for o in K2_DOUTS]
    pre_t = [r.normal(size=(n, o)).astype(np.float32) for o in K2_DOUTS]
    coeffs = np.array(jax_coeffs(n, -5.1, 9.8, "large"))
    z = r.normal(size=(b, NZ)).astype(np.float32)
    return (z, fourier, layers, pre_x, pre_t, coeffs), r.integers(-2**31, 2**31 - 1, b).astype(np.int32)


def _noise(mode: str, seeds: np.ndarray) -> dict:
    return {"stream": dict(seed=-123456789), "counter": dict(row_seeds=seeds),
            "noiseless": dict(with_noise=False)}[mode]


def _torch(obj):
    return gloo._tensors(obj)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(-2**31, 2**31 - 1), local=st.integers(1, 40), world=st.integers(1, 8))
def test_stream_row_seeds_of_a_rank_are_its_rows_of_the_unsharded_seeds(seed, local, world):
    whole = stream_row_seeds(seed, local * world)
    for rank in range(world):
        got = stream_row_seeds(seed, local, row_base=rank * local)
        assert torch.equal(got, whole[rank * local:(rank + 1) * local])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_k4a_gathered_equals_the_unsharded_plain_chain(group, world, mode):
    """B=10 (padded to 12 on 4 ranks), 5 steps at 0.3: every rank gets the
    whole result, each launched its own rows at its row_base."""
    z, w, seeds = _k1_inputs(10, seed=world)
    kw = dict(steps=5, step_size=0.3, **_noise(mode, seeds))
    want = k1.prior_langevin_plain(*_torch([z, *w]), **_torch(kw)).numpy()
    results = group(world).run(gloo.sharded_kernel, "K1", [z, *w], kw)
    local = -(-10 // world)
    for rank, (got, calls) in enumerate(results):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert calls == [(local, rank * local)]
    assert all(np.array_equal(results[0][0], r[0]) for r in results)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_k4b_gathered_equals_the_unsharded_plain_sweep(group, world, mode):
    """B=10, 3 steps: rows and pre_x split, pre_t, coefficients and weights
    replicated."""
    args, seeds = _k2_inputs(10, 3, seed=world)
    kw = dict(steps=3, **_noise(mode, seeds))
    want = k2.reverse_sweep_plain(*_torch(args), **_torch(kw)).numpy()
    results = group(world).run(gloo.sharded_kernel, "K2", list(args), kw)
    local = -(-10 // world)
    for rank, (got, calls) in enumerate(results):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert calls == [(local, rank * local)]
    assert all(np.array_equal(results[0][0], r[0]) for r in results)


@pytest.mark.parametrize("world", [2, 4])
def test_k4a_counter_mode_matches_jax_sharded(group, world):
    """16 chains, 20 noisy steps at 0.4 in counter mode, against JAX's
    shard_map over `make_mesh(n_data=world)`: atol 1e-5."""
    z, w, seeds = _k1_inputs(16, seed=10 + world)
    kw = dict(steps=20, step_size=0.4)
    got = group(world).run(gloo.sharded_kernel, "K1", [z, *w], dict(row_seeds=seeds, **kw))
    j = jnp.asarray
    want = np.asarray(jax_k4a(jax_make_mesh(n_data=world), j(z), *map(j, w), row_seeds=j(seeds),
                              interpret="plain", **kw))
    for out, _ in got:
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)
    assert np.std(want) > 0.5  # the noise is there


@pytest.mark.parametrize("world", [2, 4])
def test_k4b_counter_mode_matches_jax_sharded(group, world):
    """8 rows, 6 noisy steps in counter mode, against JAX's shard_map over
    `make_mesh(n_data=world)`: atol 2e-4, rtol 1e-4."""
    (z, fourier, layers, pre_x, pre_t, coeffs), seeds = _k2_inputs(8, 6, seed=20 + world)
    got = group(world).run(gloo.sharded_kernel, "K2", [z, fourier, layers, pre_x, pre_t, coeffs],
                           dict(steps=6, row_seeds=seeds))
    j = jnp.asarray
    want = np.asarray(jax_k4b(
        jax_make_mesh(n_data=world), j(z), j(fourier), [tuple(map(j, lt)) for lt in layers],
        [j(t) for t in pre_x], [j(t) for t in pre_t], j(coeffs), steps=6, residual=True,
        interpret="plain", row_seeds=j(seeds),
    ))
    for out, _ in got:
        np.testing.assert_allclose(out, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_make_global_batch_assembles_the_ranks_rows(group, world):
    """Each rank passes its rows; every rank gets the global batch, bit for
    bit (the gather adds zeros only)."""
    x = np.random.default_rng(world).normal(size=(4 * world, 3, 2)).astype(np.float32)
    for got in group(world).run(gloo.global_batch, x):
        assert np.array_equal(got, x)


def test_a_world_of_one_launches_the_unsharded_kernels(monkeypatch):
    """With no mesh, or a mesh of one rank, K4a and K4b are K1 and K2 on the
    whole batch: no process group exists here, so a collective would
    raise."""
    assert not dist.is_initialized()
    one = Mesh(rank=0, world=1, device=torch.device("cpu"))
    z, w, seeds = _k1_inputs(6, seed=1)
    args, _ = _k2_inputs(6, 2, seed=1)
    for mesh in (None, one):
        got = k1.fused_prior_langevin_sharded(mesh, *_torch([z, *w]), seed=5, steps=3)
        assert torch.equal(got, k1.fused_prior_langevin(*_torch([z, *w]), seed=5, steps=3))
        got = k2.fused_reverse_sweep_sharded(mesh, *_torch(args), seed=5, steps=2)
        assert torch.equal(got, k2.fused_reverse_sweep(*_torch(args), seed=5, steps=2))
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: pytest.fail("a collective in a world of 1"))
    k1.fused_prior_langevin_sharded(one, *_torch([z, *w]), seed=5, steps=3)
    k2.fused_reverse_sweep_sharded(one, *_torch(args), seed=5, steps=2)


def test_nccl_is_never_taken_for_ranks_that_share_a_card():
    """nccl on the CPU raises before any rendezvous; two ranks that report
    the same card (`_refuse_shared_cards`, fed through one store) both
    raise, naming gloo; distinct cards pass."""
    with pytest.raises(ValueError, match="gloo"):
        pd.initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    assert not dist.is_initialized()
    for cards, fails in ((("host/GPU-a", "host/GPU-a"), True), (("host/GPU-a", "host/GPU-b"), False)):
        store, errors = dist.HashStore(), {}

        def rank(r):
            try:
                pd._refuse_shared_cards(store, r, 2, cards[r])
            except ValueError as e:
                errors[r] = str(e)

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        assert sorted(errors) == ([0, 1] if fails else [])
        assert all("--dist_backend gloo" in e for e in errors.values())


def test_bad_explicit_setups_raise():
    """A process id outside the world, and a coordinator nobody serves,
    raise (JAX's explicit branch, tests/test_distributed.py:107)."""
    with pytest.raises(ValueError, match="not below"):
        pd.initialize_distributed("127.0.0.1:1", 2, 5, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="dist backend"):
        pd.initialize_distributed("127.0.0.1:1", 2, 0, backend="mpi", device="cpu")
    with pytest.raises(RuntimeError):
        pd.initialize_distributed(f"127.0.0.1:{gloo.free_port()}", 2, 1, backend="gloo", device="cpu",
                                  timeout_s=2)
    assert not dist.is_initialized()
    pd.initialize_distributed(backend="gloo", device="cpu")  # no coordinator, no torchrun: one process
    assert not dist.is_initialized() and pd.world_size() == 1
