"""The port's training feed and loop on the CPU: `DeviceDataset`'s epoch
invariants, a 3-iteration `train_gen_recon` at tiny widths, the placement
that raises, and the train-mode models."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from damc_tpu_torch.config import preset
from damc_tpu_torch.data.device_data import DeviceDataset, data_seed
from damc_tpu_torch.models import build_models, sample_q
from damc_tpu_torch.train.gen_recon import train_gen_recon
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import PHASES, draw_step, make_train_step, stream_seeds
from torch_port_helpers import tiny


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)


def test_device_dataset_epochs_visit_each_image_once():
    """37 images, batches of 5: 7 batches an epoch (drop-last), no image
    twice in an epoch, a fresh order each epoch."""
    images = _images(37)
    ds = DeviceDataset(images, batch_size=5, seed=3, device="cpu")
    stream = ds.stream()
    epochs = []
    for _ in range(3):
        idx = torch.cat([next(stream)[1] for _ in range(len(ds))])
        assert len(idx) == 35 and len(set(idx.tolist())) == 35
        epochs.append(idx)
    assert not torch.equal(epochs[0], epochs[1])


def test_device_dataset_values_range_and_flip_share():
    """uint8 -> x / 255 * 2 - 1 in [-1, 1] exactly at the ends; each sample
    is either the image or its mirror, mirrored with share near 1/2
    (2000 draws: 5 sigma is 0.056)."""
    images = _images(40, seed=1)
    images[0] = 0
    images[1] = 255
    ds = DeviceDataset(images, batch_size=40, augment_flip=True, seed=5, device="cpu")
    stream = ds.stream()
    flips = total = 0
    for _ in range(50):
        x, idx = next(stream)
        assert x.dtype == torch.float32 and x.shape == (40, 8, 8, 3)
        assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
        plain = torch.from_numpy(images[idx.numpy()]).float() / 255.0 * 2.0 - 1.0
        same = (x == plain).flatten(1).all(1)
        mirrored = (x == plain.flip(2)).flatten(1).all(1)
        assert bool((same | mirrored).all())
        flips += int((mirrored & ~same).sum())
        total += int((~(same & mirrored)).sum())  # symmetric images say nothing
        if 0 in idx.tolist():
            assert float(x[idx.tolist().index(0)].max()) == -1.0
        if 1 in idx.tolist():
            assert float(x[idx.tolist().index(1)].min()) == 1.0
    assert abs(flips / total - 0.5) < 5 * 0.5 / np.sqrt(total)


def test_device_dataset_rejects_bad_stores():
    with pytest.raises(ValueError, match="no batches"):
        DeviceDataset(_images(3), batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="uint8/float32"):
        DeviceDataset(np.zeros((4, 8, 8), np.uint8), device="cpu")


def _contains_run(stream, run):
    n = len(run)
    return any(torch.equal(stream[i:i + n], run) for i in range(len(stream) - n + 1))


def test_device_dataset_draws_apart_from_the_step_draws():
    """A dataset and a training state made from one seed draw unrelated
    bits: the dataset's generator is seeded with `data_seed(seed)`. The
    first batch's flip uniforms (replayed on a copy of its generator) do
    not appear as a run anywhere in the first 4096 uniforms of the state's
    generator, the stream `draw_step` takes mask_u, z0_init and the rest
    from; seeded with the run seed itself, they do."""
    cfg, seed, b = _tiny_cfg(), 11, 8
    ds = DeviceDataset(_images(40), batch_size=b, augment_flip=True, seed=seed, device="cpu")
    state = create_state(cfg, seed=seed, device="cpu")
    assert ds.gen.initial_seed() == data_seed(seed) != state.rng.initial_seed() == seed

    def flip_uniforms(gen_state):
        g = torch.Generator().set_state(gen_state)
        torch.randperm(ds.n, generator=g)
        return torch.rand(b, generator=g)

    step_stream = torch.rand(4096, generator=torch.Generator().set_state(state.rng.get_state()))
    d = draw_step(cfg, b, state)
    assert torch.equal(d.mask_u, step_stream[:b])
    assert not _contains_run(step_stream, flip_uniforms(ds.gen.get_state()))
    assert _contains_run(step_stream, flip_uniforms(torch.Generator().manual_seed(seed).get_state()))


def _tiny_cfg(**train_kw):
    cfg = tiny(preset("svhn"))
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=4, q_updates=2, **train_kw)
    )


def test_train_gen_recon_three_iterations_on_cpu(capsys):
    """Three iterations with every kernel's noise on (stream mode), metrics
    printed at iterations 0 and 2 (print_every 2), the EMA mixed once
    (ema_every 3), every network changed, every metric finite."""
    cfg = _tiny_cfg(print_every=2, ema_every=3)
    images = np.random.default_rng(2).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    start = create_state(cfg, seed=7, device="cpu")
    seen = []
    state = train_gen_recon(
        cfg, images, iterations=3, seed=7, device="cpu",
        on_step=lambda it, st, m: seen.append((it, st.step, sorted(m))),
    )
    assert state.step == 3 and [s[:2] for s in seen] == [(0, 1), (1, 2), (2, 3)]
    assert seen[0][2] == sorted(
        ["g_loss", "q_loss", "post_energy_final", "zk_pos_abs_max", "e_pos", "e_neg", "prior_energy_final"]
    )
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[train] ")]
    assert len(lines) == 2 and '"iter": 2' in lines[1]
    for before, after in zip(start.models.modules(), state.models.modules()):
        assert any(not torch.equal(a, b) for a, b in zip(before.parameters(), after.parameters()))
    ema_moved = [not torch.equal(a, b) for a, b in zip(start.amortizer_ema.parameters(), state.amortizer_ema.parameters())]
    assert any(ema_moved)


def test_unported_options_raise():
    """The host data feed is ported now (the name predates that; both
    drivers train host-fed in tests/test_torch_port_host_feed.py): what
    still raises is 'device' over the device budget, in both drivers that
    read it, gen_recon's and the anomaly workload's, as in JAX."""
    from damc_tpu_torch.train.anomaly import train_anomaly

    cfg = _tiny_cfg(data_placement="device", data_device_budget_gb=1e-6)
    images = np.zeros((8, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="data_placement='device' but the store is ineligible"):
        train_gen_recon(cfg, images, iterations=1, device="cpu")
    anomaly = preset("mnist_anomaly")
    anomaly = dataclasses.replace(anomaly, train=dataclasses.replace(
        anomaly.train, data_placement="device", data_device_budget_gb=1e-6))
    with pytest.raises(ValueError, match="over the device budget"):
        train_anomaly(anomaly, np.zeros((8, 28, 28, 1), np.float32), iterations=1, device="cpu")


def test_unported_dtypes_and_scan_chain_raise():
    """The JAX step's bfloat16 switches are ported now (the name predates
    that): with `pallas_dots_dtype` or `compute_dtype` "bfloat16" the
    models build, G and the conv encoder compute in bfloat16 where asked,
    and one iteration steps with finite metrics and float32 parameters
    (tests/test_torch_port_bf16.py holds the bf16 step to JAX's). The scan
    prior chain (use_pallas=False) builds too
    (tests/test_torch_port_unfused_sweep.py holds that step to JAX's)."""
    cfg = _tiny_cfg()
    state = create_state(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32))
    for section, kw in (("train", dict(pallas_dots_dtype="bfloat16")),
                        ("model", dict(compute_dtype="bfloat16"))):
        bf16 = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})
        st = create_state(bf16, seed=0, device="cpu")
        want = torch.bfloat16 if section == "model" else torch.float32
        assert st.models.generator.dtype == want and st.models.amortizer.encoder.dtype == want
        assert build_models(bf16, device="cpu").generator.dtype == want
        st, metrics = make_train_step(st.models, st.opts, bf16)(st, x, draw_step(bf16, 8, st))
        assert st.step == 1 and all(bool(torch.isfinite(v)) for v in metrics.values())
        assert all(p.dtype == torch.float32 for m in st.models.modules() for p in m.parameters())
    scan = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    assert callable(make_train_step(state.models, state.opts, scan))


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gen_recon(_tiny_cfg(), np.zeros((8, 32, 32, 3), np.uint8), iterations=1)


def test_trainable_models_compute_as_frozen_ones():
    """train() and requires_grad change nothing in the forward passes: no
    dropout, and InstanceNorm2d keeps no running statistics."""
    cfg = _tiny_cfg()
    frozen = build_models(cfg, seed=3, device="cpu")
    train = build_models(cfg, seed=3, device="cpu", trainable=True)
    assert all(p.requires_grad for m in train.modules() for p in m.parameters())
    assert all(m.training for m in train.amortizer.modules())
    assert not any(n.track_running_stats for n in train.amortizer.modules()
                   if isinstance(n, torch.nn.InstanceNorm2d))
    x = torch.rand(3, 32, 32, 3) * 2 - 1
    z = torch.randn(3, cfg.model.nz)
    assert torch.equal(frozen.amortizer.encode(x), train.amortizer.encode(x))
    assert torch.equal(frozen.generator(z), train.generator(z))


def test_draw_step_and_stream_seeds():
    """A step's draws have the config's shapes; the kernels' stream seeds
    are a pure function of (run seed, iteration) and differ between the
    two kernels and from one iteration to the next."""
    cfg = _tiny_cfg(q_loss_both_branches=True)
    state = create_state(cfg, seed=4, device="cpu")
    d = draw_step(cfg, 4, state)
    nz = cfg.model.nz
    assert d.mask_u.shape == (4,) and d.z0_init.shape == d.neg_init.shape == (4, nz)
    assert d.post_noise.shape == (cfg.mcmc.g_l_steps, 4, nz)
    assert len(d.q) == 2 and all(b is not None and b.u.shape == (4,) for _, b in d.q)
    assert (d.sweep_seed, d.chain_seed) == stream_seeds(4, 0)
    assert stream_seeds(4, 0) != stream_seeds(4, 1) and len(set(stream_seeds(4, 0))) == 2
    assert all(-(2**31) <= s < 2**31 for s in stream_seeds(2**40 + 3, 10**6))


def test_phases_are_labelled_for_the_profiler():
    """Each of the seven phases runs under its record_function label."""
    cfg = _tiny_cfg()
    state = create_state(cfg, seed=1, device="cpu")
    step = make_train_step(state.models, state.opts, cfg)
    x = torch.rand(4, 32, 32, 3) * 2 - 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, x)
    names = {e.key for e in prof.key_averages()}
    assert {f"train/{p}" for p in PHASES} <= names


def test_sample_q_stream_mode_is_the_sweep_of_the_encoding():
    """`sample_q` = the plain stream-mode sweep over the encoder's
    embedding; another seed gives another draw."""
    cfg = _tiny_cfg()
    models = build_models(cfg, seed=2, device="cpu")
    x = torch.rand(3, 32, 32, 3) * 2 - 1
    z = torch.randn(3, cfg.model.nz)
    a = sample_q(models.amortizer, x, z, seed=5)
    assert a.shape == (3, cfg.model.nz) and torch.isfinite(a).all() and not a.requires_grad
    assert torch.equal(a, sample_q(models.amortizer, x, z, seed=5))
    assert not torch.equal(a, sample_q(models.amortizer, x, z, seed=6))
