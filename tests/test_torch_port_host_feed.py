"""The port's host feed on the CPU: `train/driver_utils.py::make_batch_source`
with the C++ batch engine (`data/native_loader.py`), the NumPy `Loader`
and the `Prefetcher`, against the JAX package's `make_batch_source` on the
same stores and seeds (batch for batch, exactly); the device budget's
fallback and refusal; the Prefetcher's error latching and `close()`; and
both drivers training host-fed at tiny widths, with the feed's threads
stopped however the loop ends."""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import damc_tpu.data.native_jpeg as jax_native_jpeg
from damc_tpu.data import datasets as jax_datasets
from damc_tpu.train import driver_utils as jax_driver_utils
from damc_tpu_torch.config import preset
from damc_tpu_torch.data import datasets, native_loader
from damc_tpu_torch.data.device_data import DEFAULT_DEVICE_BUDGET_BYTES, fits_device
from damc_tpu_torch.data.prefetch import Prefetcher
from damc_tpu_torch.train import anomaly, driver_utils, gen_recon
import torch_port_helpers
from torch_port_helpers import lsun_jpeg_db, tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


def _tc(placement="host", budget_gb=None, batch_size=5):
    return SimpleNamespace(data_placement=placement, data_device_budget_gb=budget_gb, batch_size=batch_size)


def _stores(tmp_path, monkeypatch):
    """The three kinds of host store: uint8 (C++ engine), float32 in [-1, 1]
    (NumPy Loader, as the anomaly workload feeds it) and a lazy LSUN view
    (Loader, JPEG payloads). JAX's LSUN batches go through PIL here: its
    libjpeg batch path, which the port does not copy, is switched off."""
    rng = np.random.default_rng(0)
    lsun_jpeg_db(str(tmp_path), "tower_train", 13, seed=1, max_size=(60, 50))
    monkeypatch.setattr(jax_native_jpeg, "native_jpeg_available", lambda: False)
    return {
        "uint8": (rng.integers(0, 256, (23, 6, 5, 3), dtype=np.uint8),) * 2,
        "float": (rng.uniform(-1, 1, (21, 7, 7, 1)).astype(np.float32),) * 2,
        "lazy_lsun": (datasets.LSUNImages(str(tmp_path), ["tower_train"], size=16),
                      jax_datasets.LSUNImages(str(tmp_path), ["tower_train"], size=16)),
    }


@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip"])
@pytest.mark.parametrize("kind", ["uint8", "float", "lazy_lsun"])
def test_host_batches_equal_jax_for_two_epochs(tmp_path, monkeypatch, kind, flip):
    """`make_batch_source(..., 'host')` of both packages on one store and
    seed: the same batches, in order, for two epochs."""
    store_p, store_j = _stores(tmp_path, monkeypatch)[kind]
    next_p, close_p, place_p = driver_utils.make_batch_source(store_p, _tc(), 7, "cpu", augment_flip=flip)
    next_j, close_j, place_j = jax_driver_utils.make_batch_source(store_j, _tc(), None, 7, augment_flip=flip)
    assert place_p == place_j == "host"
    try:
        for _ in range(2 * (len(store_p) // 5)):
            got, want = next_p(), np.asarray(next_j())
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        close_p()
        close_j()


def test_make_loader_picks_as_jax_does(tmp_path, monkeypatch):
    stores = _stores(tmp_path, monkeypatch)
    pick = lambda kind, **kw: type(native_loader.make_loader(stores[kind][0], batch_size=4, **kw))
    assert pick("uint8") is native_loader.NativeLoader
    assert pick("float") is pick("lazy_lsun") is pick("uint8", drop_last=False) is datasets.Loader


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_native_engine_stream_does_not_depend_on_threads(threads):
    """The engine's stream for one seed is the same whatever its thread
    count: batches are handed out in the order they were claimed."""
    store = np.random.default_rng(1).integers(0, 256, (40, 4, 4, 3), dtype=np.uint8)
    one = native_loader.NativeLoader(store, 6, augment_flip=True, seed=2, num_threads=1)
    many = native_loader.NativeLoader(store, 6, augment_flip=True, seed=2, num_threads=threads)
    try:
        for _ in range(13):
            a, b = one.next(), many.next()
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[0].min() >= -1.0 and a[0].max() <= 1.0 and len(set(a[1].tolist())) == 6
    finally:
        one.close()
        many.close()
    assert len(one) == 6
    with pytest.raises(StopIteration):
        one.next()


@pytest.mark.parametrize("placement, budget_gb, want", [
    ("auto", None, "device"), ("auto", 1e-6, "host"), ("host", None, "host"), ("device", 1.0, "device"),
])
def test_placement_and_budget_as_jax(placement, budget_gb, want):
    """'auto' keeps a store under the budget on the device and falls back
    to the host over it, as the JAX package does; `fits_device` and the
    8 GiB default are JAX's."""
    store = np.random.default_rng(2).integers(0, 256, (12, 8, 8, 3), dtype=np.uint8)
    tc = _tc(placement, budget_gb, batch_size=4)
    next_p, close_p, got = driver_utils.make_batch_source(store, tc, 0, "cpu")
    _, close_j, jax_got = jax_driver_utils.make_batch_source(store, tc, None, 0)
    try:
        assert got == jax_got == want
        x = next_p()
        assert x.shape == (4, 8, 8, 3) and x.dtype == torch.float32
    finally:
        close_p()
        close_j()
    assert DEFAULT_DEVICE_BUDGET_BYTES == 8 << 30
    assert fits_device(store, store.nbytes) and not fits_device(store, store.nbytes - 1)
    assert not fits_device(store.astype(np.int16)) and not fits_device(list(store))


@pytest.mark.parametrize("store", ["over_budget", "lazy"])
def test_device_placement_over_budget_raises_as_jax(tmp_path, store):
    if store == "lazy":
        lsun_jpeg_db(str(tmp_path), "tower_val", 4, seed=3)
        images = datasets.LSUNImages(str(tmp_path), ["tower_val"], size=8)
        tc = _tc("device", None, batch_size=2)
    else:
        images = np.zeros((6, 8, 8, 3), np.uint8)
        tc = _tc("device", 1e-6, batch_size=2)
    with pytest.raises(ValueError, match="data_placement='device' but the store is ineligible"):
        driver_utils.make_batch_source(images, tc, 0, "cpu")
    with pytest.raises(ValueError, match="data_placement='device' but the store is ineligible"):
        jax_driver_utils.make_batch_source(images, tc, None, 0)
    with pytest.raises(ValueError, match="data_placement must be auto"):
        driver_utils.make_batch_source(images, _tc("hbm"), 0, "cpu")


def test_put_batch_on_the_cpu_keeps_the_batch():
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 3, 3)).astype(np.float32)
    t = driver_utils.put_batch(x, torch.device("cpu"))
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), x)


# ---------------------------------------------------------------------------
# Prefetcher (the port's copy of damc_tpu/data/prefetch.py)
# ---------------------------------------------------------------------------


def test_prefetcher_yields_in_order_and_latches_the_end():
    pf = Prefetcher(iter(range(50)), depth=3)
    assert list(pf) == list(range(50))
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pf)
    pf.close()


def test_prefetcher_latches_a_producer_error():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom in the producer")

    pf = Prefetcher(gen(), depth=2)
    assert next(pf) == 1 and next(pf) == 2
    for _ in range(3):  # raised again at every later call
        with pytest.raises(RuntimeError, match="boom in the producer"):
            next(pf)
    pf.close()


def test_prefetcher_close_keeps_an_unconsumed_error():
    def gen():
        raise ValueError("bad batch")
        yield  # pragma: no cover

    pf = Prefetcher(gen(), depth=2)
    deadline = time.monotonic() + 5.0
    while pf._queue.empty() and time.monotonic() < deadline:
        time.sleep(0.01)
    pf.close()
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)


def test_prefetcher_close_stops_a_blocked_producer():
    produced = []

    def gen():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    pf = Prefetcher(gen(), depth=1)
    assert next(pf) == 0
    time.sleep(0.2)  # the producer fills the queue and blocks
    pf.close()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive() and len(produced) < 10
    with pytest.raises(StopIteration):
        next(pf)


# ---------------------------------------------------------------------------
# The drivers, host-fed
# ---------------------------------------------------------------------------


def _record_closes(monkeypatch, module, log):
    """Wrap `module.make_batch_source` so that each source's placement and
    the calls of its `close` are logged."""
    original = module.make_batch_source

    def make(*args, **kwargs):
        next_batch, close, placement = original(*args, **kwargs)
        entry = {"placement": placement, "closed": 0}
        log.append(entry)

        def counted_close():
            entry["closed"] += 1
            close()

        return next_batch, counted_close, placement

    monkeypatch.setattr(module, "make_batch_source", make)


def _threads_named_like_the_prefetcher():
    return [t for t in threading.enumerate() if t.is_alive() and getattr(t, "_target", None) is not None
            and t._target.__name__ == "_fill"]


def test_gen_recon_trains_host_fed_and_closes_its_feed(monkeypatch, capsys):
    """Two iterations of `train_gen_recon` with data_placement 'host' on a
    uint8 store (the C++ engine), then two with 'auto' on a lazy LSUN view
    (Loader and Prefetcher): finite metrics, 'host' printed, the feed
    closed after each run and no prefetch thread left."""
    cfg = tiny(preset("svhn"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=4, q_updates=2,
                                                             data_placement="host", print_every=1))
    log = []
    _record_closes(monkeypatch, gen_recon, log)
    images = np.random.default_rng(5).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    seen = []
    state = gen_recon.train_gen_recon(cfg, images, iterations=2, seed=3, device="cpu",
                                      on_step=lambda it, st, m: seen.append({k: float(v) for k, v in m.items()}))
    assert state.step == 2 and all(np.isfinite(v) for m in seen for v in m.values())
    assert "[damc] training-batch placement: host" in capsys.readouterr().out
    assert log == [{"placement": "host", "closed": 1}]


def test_gen_recon_lazy_store_and_preemption_close_the_feed(tmp_path, monkeypatch, capsys):
    """A lazy LSUN store under 'auto' takes the host feed; a SIGTERM after
    the first iteration checkpoints and stops the loop, and the feed's
    prefetch thread is stopped."""
    lsun_jpeg_db(str(tmp_path / "lsun"), "tower_train", 9, seed=6)
    view = datasets.LSUNImages(str(tmp_path / "lsun"), ["tower_train"], size=32)
    cfg = tiny(preset("svhn"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=4, q_updates=2, ckpt_every=0))
    log = []
    _record_closes(monkeypatch, gen_recon, log)

    def preempt(it, st, m):
        if it == 0:
            handler = signal.getsignal(signal.SIGTERM)
            assert handler not in (signal.SIG_DFL, signal.SIG_IGN), "the loop's handler is not installed"
            signal.raise_signal(signal.SIGTERM)

    state = gen_recon.train_gen_recon(cfg, view, iterations=5, seed=3, device="cpu", on_step=preempt,
                                      log_dir=str(tmp_path / "run"))
    out = capsys.readouterr().out
    assert state.step == 1 and "checkpointed to" in out and "placement: host" in out
    assert log == [{"placement": "host", "closed": 1}]
    deadline = time.monotonic() + 5.0
    while _threads_named_like_the_prefetcher() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _threads_named_like_the_prefetcher()


def test_anomaly_trains_host_fed_without_flips(monkeypatch, capsys):
    """The anomaly driver on the host feed: its float store goes through
    the NumPy Loader with flips off (as JAX's `augment_flip=False`), and a
    failing step still closes the feed. One process passes no mesh."""
    cfg = tiny(preset("mnist_anomaly"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=8, q_updates=2,
                                                             data_placement="host"))
    log, calls = [], []
    _record_closes(monkeypatch, anomaly, log)
    original = anomaly.make_batch_source
    monkeypatch.setattr(anomaly, "make_batch_source",
                        lambda *a, **k: (calls.append(k), original(*a, **k))[1])
    images = np.random.default_rng(7).uniform(-1, 1, (20, 28, 28, 1)).astype(np.float32)
    state, _ = anomaly.train_anomaly(cfg, images, iterations=2, seed=2, device="cpu")
    assert state.step == 2 and calls == [{"augment_flip": False, "mesh": None}]
    assert log == [{"placement": "host", "closed": 1}]
    assert "placement: host" in capsys.readouterr().out

    def broken_step(*a, **k):
        raise RuntimeError("step failed")

    monkeypatch.setattr(anomaly, "make_train_step", lambda *a, **k: broken_step)
    with pytest.raises(RuntimeError, match="step failed"):
        anomaly.train_anomaly(cfg, images, iterations=2, seed=2, device="cpu")
    assert log[-1] == {"placement": "host", "closed": 1}
