"""The port's serving slice: end-to-end parity with the JAX package's fused
serving programs, and the runtime contracts (micro-batching, per-request
determinism, bucket sizes, the HTTP front, the device default)."""

from __future__ import annotations

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.serve import build_serving_fns as jax_serving_fns
from damc_tpu_torch.config import preset
from damc_tpu_torch.models import build_models
from damc_tpu_torch.serve import (
    BatchStats,
    MicroBatcher,
    RowDraws,
    SamplerService,
    bucket_size,
    build_serving_fns,
    item_draws,
    make_http_server,
)
from torch_port_helpers import jax_and_port, tiny

RECON_STEPS = 2


@pytest.fixture(scope="module")
def setup():
    return jax_and_port(seed=0)


def _normal_rows(keys, nz):
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (nz,)))(keys))


def _seed_rows(keys):
    return np.asarray(
        jax.vmap(lambda k: jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32))(keys)
    )


def _jax_draws(path, keys, nz) -> RowDraws:
    """The per-row inputs the JAX fused serving programs derive from their
    keys (`damc_tpu/serve.py:322-366`, `models/amortizer.py:382-436`)."""
    split3 = jax.vmap(lambda k: jax.random.split(k, 3))
    split2 = jax.vmap(jax.random.split)
    b = keys.shape[0]
    emb, sweep, chain = np.zeros((b, nz), np.float32), np.zeros(b, np.int32), np.zeros(b, np.int32)
    if path == "damc":
        ks = split3(keys)
        z, emb, sweep = _normal_rows(ks[:, 0], nz), _normal_rows(ks[:, 1], nz), _seed_rows(ks[:, 2])
    elif path == "recon":
        ks = split3(split2(keys)[:, 0])
        z, sweep = _normal_rows(ks[:, 0], nz), _seed_rows(ks[:, 2])
    else:
        ks = split2(keys)
        z, chain = _normal_rows(ks[:, 0], nz), _seed_rows(ks[:, 1])
    return RowDraws(*(torch.from_numpy(np.array(a)) for a in (z, emb, sweep, chain)))


@pytest.mark.parametrize("path", ["damc", "ebm", "recon"])
def test_serving_path_matches_jax(setup, path):
    """The port's serving core against `build_serving_fns(fused=True,
    fused_interpret='plain')`, fed the per-row draws the JAX program derives
    from its keys. Tolerance 1e-4 on images in [-1, 1] (and on z): fp32 on
    both sides, with the sums of the products, the convolutions and the
    posterior-Langevin autograd taken in other orders; the counter noise is
    bit-identical (test_torch_port_noise.py)."""
    cfg_j, state, models_j, cfg_p, models_p = setup
    fns_j = jax_serving_fns(
        models_j, state.params_q, state.params_g, state.params_e, cfg_j,
        recon_langevin_steps=RECON_STEPS, fused=True, fused_interpret="plain",
    )
    fns_p = build_serving_fns(models_p, cfg_p, recon_langevin_steps=RECON_STEPS)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(4))
    draws = _jax_draws(path, keys, cfg_p.model.nz)
    if path == "recon":
        x = np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
        want = [np.asarray(a) for a in jax.jit(fns_j[path][0])(keys, x)]
        got = [t.numpy() for t in fns_p[path](draws, torch.from_numpy(x))]
    else:
        want = [np.asarray(jax.jit(fns_j[path][0])(keys))]
        got = [fns_p[path](draws).numpy()]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_item_draws_are_pure_and_distinct():
    a, b = item_draws(3, 5, 8), item_draws(3, 5, 8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.z_init.shape == (1, 8) and a.sweep_seed.dtype == torch.int32
    assert not torch.equal(a.z_init, a.emb_noise)
    assert a.sweep_seed.item() != a.chain_seed.item()
    other = item_draws(3, 6, 8)
    assert not torch.equal(a.z_init, other.z_init)
    assert not torch.equal(a.z_init, item_draws(4, 5, 8).z_init)


def test_bucket_size():
    assert [bucket_size(n, 16) for n in (1, 2, 3, 4, 5, 9, 16, 40)] == [
        1, 2, 4, 4, 8, 16, 16, 16,
    ]


def test_microbatcher_coalesces_and_matches_serial():
    calls = []

    def run(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    mb = MicroBatcher(run, max_batch=8, window_ms=100.0)
    try:
        futs = [mb.submit(i) for i in range(8)]
        assert [f.result(10.0) for f in futs] == [2 * i for i in range(8)]
        assert sum(calls) == 8 and len(calls) < 8
    finally:
        mb.close()


def test_microbatcher_batch_failure_isolated():
    def run(items):
        if any(x < 0 for x in items):
            raise ValueError("negative")
        return items

    mb = MicroBatcher(run, max_batch=4, window_ms=1.0)
    try:
        with pytest.raises(ValueError):
            mb.submit(-1).result(10.0)
        assert mb.submit(3).result(10.0) == 3  # the worker survived
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(1)


def test_batch_stats_snapshot():
    s = BatchStats()
    s.record_batch(3, 1)
    s.record_request(10.0)
    snap = s.snapshot()
    assert snap["items"] == 3 and snap["padded_items"] == 1 and snap["latency_p50_ms"] == 10.0


@pytest.fixture(scope="module")
def service():
    cfg = tiny(preset("svhn"))
    svc = SamplerService(
        build_models(cfg, seed=1, device="cpu"), cfg, max_batch=4, window_ms=30.0,
        recon_langevin_steps=RECON_STEPS, device="cpu",
    )
    svc.warmup()
    yield svc
    svc.close()


@pytest.mark.parametrize("prior", ["damc", "ebm"])
def test_sample_item_independent_of_coalescing(service, prior):
    alone = service.sample(n=1, prior=prior, seed=11)
    results = {}

    def go(k, seed):
        results[k] = service.sample(n=3, prior=prior, seed=seed)

    threads = [threading.Thread(target=go, args=(k, s)) for k, s in ((0, 11), (1, 12))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert results[0].shape == (3, 32, 32, 3)
    assert np.array_equal(results[0][0], alone[0])
    assert np.all(np.abs(results[0]) <= 1.0)
    assert not np.array_equal(results[0][0], results[0][1])


def test_reconstruct_item_independent_of_coalescing(service):
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    x_hat, z = service.reconstruct(x, seed=4)
    x1, z1 = service.reconstruct(x[0], seed=4)
    assert x_hat.shape == (3, 32, 32, 3) and z.shape == (3, 8)
    assert np.array_equal(x_hat[0], x1) and np.array_equal(z[0], z1)


def test_deterministic_pads_to_max_batch_and_bucketed_to_powers_of_two():
    cfg = tiny(preset("svhn"))
    models = build_models(cfg, seed=2, device="cpu")
    for deterministic, padded in ((True, 5), (False, 1)):
        svc = SamplerService(
            models, cfg, max_batch=8, window_ms=1.0, deterministic=deterministic, device="cpu"
        )
        try:
            svc.sample(n=1, prior="damc", seed=0)  # one batch of 1 item
            assert svc.stats["damc"].padded_items == (7 if deterministic else 0)
            svc.stats["damc"].padded_items = 0
            svc._run("damc", [(item_draws(0, i, 8),) for i in range(3)])
            assert svc.stats["damc"].padded_items == padded
        finally:
            svc.close()


def test_sampler_service_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny(preset("svhn"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_models(cfg)
    models = build_models(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SamplerService(models, cfg)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _status(fn):
    try:
        return fn()[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_http_front(service):
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert sorted(health["paths"]) == ["damc", "ebm", "recon"]
        code, body = _post(base + "/sample", {"n": 2, "prior": "damc", "seed": 3})
        assert code == 200 and body["images"]["shape"] == [2, 32, 32, 3]
        code, body = _post(base + "/sample", {"n": 1, "prior": "ebm", "seed": 3, "encoding": "b64"})
        raw = base64.b64decode(body["images"]["data_b64"])
        img = np.frombuffer(raw, np.float32).reshape(body["images"]["shape"])
        assert np.array_equal(img[0], service.sample(1, "ebm", 3)[0])
        x = np.zeros((32, 32, 3), np.float32)
        code, body = _post(base + "/reconstruct", {"image": x.tolist(), "seed": 1})
        assert code == 200 and body["x_hat"]["shape"] == [32, 32, 3] and body["mse"] >= 0
        for bad in ({"prior": "nope"}, {"n": 0}, {"encoding": "xml"}):
            assert _status(lambda: _post(base + "/sample", bad)) == 400
        assert _status(lambda: _post(base + "/reconstruct", {"seed": 1})) == 400
        assert _status(lambda: _post(base + "/nowhere", {})) == 404
        assert _status(lambda: urllib.request.urlopen(base + "/nowhere", timeout=30)) == 404
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["damc"]["requests"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
