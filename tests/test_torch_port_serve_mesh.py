"""Serving over several devices of one process (`parallel.LocalMesh`,
`SamplerService(mesh=)`, `cli.serve --use_mesh`) on the CPU, against the
one-device service and the JAX package's mesh service.

  * A service over `LocalMesh(["cpu", "cpu"])` against the one-device
    service on the same weights and requests: the recon path's z and the
    kernels' outputs on the ebm and recon paths bit for bit (per-row
    counter noise), K2's on the damc path within 1e-6 (the test states
    why); images within 1e-6 (G decodes 2 rows where the one-device
    service decodes 4, and the recon path's autograd runs at those sizes).
    K1 and K2 run once a device a dispatch, on its half of the rows.
  * The mesh service's core against JAX's `SamplerService(mesh=
    make_mesh(n_data=2), fused=True, fused_interpret="plain")` on 2 of the
    conftest's CPU devices, fed the per-row draws the JAX programs derive
    from their keys: 1e-4, the limit tests/test_torch_port_serve.py and the
    artifact tests hold the one-device core to.
  * The refusals (max_batch that does not divide over the devices; a
    service inside a group of 2 processes, on a `torch_port_gloo` group; a
    LocalMesh naming a CUDA device this process lacks) and the bucketed
    mode's buckets against JAX's `_bucket_for` on its mesh.
  * The serve CLI: `--use_mesh` on one device builds the one-device
    service, `--multihost` is refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_gloo as gloo
from damc_tpu.parallel import make_mesh as jax_make_mesh
from damc_tpu.serve import SamplerService as JaxSamplerService
from damc_tpu_torch import serve
from damc_tpu_torch.cli import serve as serve_cli
from damc_tpu_torch.config import preset
from damc_tpu_torch.models import amortizer, build_models
from damc_tpu_torch.parallel import LocalMesh
from damc_tpu_torch.serve import SamplerService, item_draws
from test_torch_port_serve import RECON_STEPS, _jax_draws
from torch_port_helpers import jax_and_port, one_torch_thread, tiny

MAX_BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def _recording(monkeypatch, current):
    """Record every output of the serving core's K2 (`sample_q_per_item`)
    and K1 (`prior_langevin_auto`) calls in the list `current["log"]`."""
    q, chain = amortizer.sample_q_per_item, serve.prior_langevin_auto
    monkeypatch.setattr(amortizer, "sample_q_per_item",
                        lambda *a, **kw: (lambda z: (current["log"].append(("K2", z)), z)[1])(q(*a, **kw)))
    monkeypatch.setattr(serve, "prior_langevin_auto", lambda *a, **kw: (
        lambda out: (current["log"].append(("K1", out[0])), out)[1])(chain(*a, **kw)))


def test_local_mesh_service_matches_one_device(monkeypatch):
    cfg = tiny(preset("svhn"))
    current, logs, outs = {}, {}, {}
    _recording(monkeypatch, current)
    services = {
        name: SamplerService(build_models(cfg, seed=1, device="cpu"), cfg, max_batch=MAX_BATCH,
                             recon_langevin_steps=RECON_STEPS, device="cpu", mesh=mesh, window_ms=200.0)
        for name, mesh in (("one", None), ("two", LocalMesh(["cpu", "cpu"])))
    }
    one, two = services["one"], services["two"]
    assert two.device == torch.device("cpu") and two.mesh.world == 2
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    try:
        for name, svc in services.items():
            current["log"] = logs[name] = []
            outs[name] = [svc.sample(3, "damc", seed=5), svc.sample(3, "ebm", seed=6), *svc.reconstruct(x, seed=4)]
    finally:
        one.close()
        two.close()
    for a, b in zip(outs["one"], outs["two"]):
        assert a.shape == b.shape and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    assert np.array_equal(outs["one"][3], outs["two"][3])  # the recon path's z
    # One call a dispatch on one device, one a device on its 2 rows on two;
    # the two halves are the one launch's rows: bit for bit on the ebm and
    # recon paths; on the damc path within 1e-6 (measured 9.5e-7), since on
    # the CPU the prior embedding's and the plain sweep's products sum a row
    # differently at 2 rows than at 4. The card's kernels do not
    # (chip_smoke.py holds them bit for bit there).
    assert [(k, z.shape[0]) for k, z in logs["one"]] == [("K2", 4), ("K1", 4), ("K2", 4)]
    assert [(k, z.shape[0]) for k, z in logs["two"]] == [("K2", 2)] * 2 + [("K1", 2)] * 2 + [("K2", 2)] * 2
    halves = [torch.cat([logs["two"][2 * i][1], logs["two"][2 * i + 1][1]]) for i in range(3)]
    torch.testing.assert_close(halves[0], logs["one"][0][1], atol=1e-6, rtol=0)
    assert torch.equal(halves[1], logs["one"][1][1]) and torch.equal(halves[2], logs["one"][2][1])


@pytest.mark.parametrize("path", ["damc", "ebm", "recon"])
def test_local_mesh_core_matches_jax_mesh_service(path):
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=0)
    svc_j = JaxSamplerService(state, models_j, cfg_j, max_batch=MAX_BATCH, recon_langevin_steps=RECON_STEPS,
                              mesh=jax_make_mesh(n_data=2), fused=True, fused_interpret="plain")
    svc_p = SamplerService(models_p, cfg_p, max_batch=MAX_BATCH, recon_langevin_steps=RECON_STEPS,
                           mesh=LocalMesh(["cpu", "cpu"]))
    try:
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(MAX_BATCH))
        draws = _jax_draws(path, keys, cfg_p.model.nz)
        if path == "recon":
            x = np.random.default_rng(0).uniform(-1, 1, (MAX_BATCH, 32, 32, 3)).astype(np.float32)
            want = [np.asarray(a) for a in svc_j._fns[path](keys, x)]
            got = [t.numpy() for t in svc_p._fns[path](draws, torch.from_numpy(x))]
        else:
            want = [np.asarray(svc_j._fns[path](keys))]
            got = [svc_p._fns[path](draws).numpy()]
    finally:
        svc_j.close()
        svc_p.close()
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_refusals_and_mesh_buckets(group):
    cfg = tiny(preset("svhn"))
    models = build_models(cfg, seed=2, device="cpu")
    with pytest.raises(ValueError, match="max_batch=5 must be divisible by the mesh's 2 devices"):
        SamplerService(models, cfg, max_batch=5, mesh=LocalMesh(["cpu", "cpu"]))
    for message in group(2).run(gloo.serve_in_group):
        assert message is not None and "single-process" in message
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalMesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        LocalMesh([])

    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=0)
    svc_j = JaxSamplerService(state, models_j, cfg_j, max_batch=8, deterministic=False,
                              mesh=jax_make_mesh(n_data=2), fused=True, fused_interpret="plain")
    svc_p = SamplerService(models_p, cfg_p, max_batch=8, deterministic=False, mesh=LocalMesh(["cpu", "cpu"]))
    try:
        buckets = [svc_p._bucket_for(n) for n in range(1, 9)]
        assert buckets == [svc_j._bucket_for(n) for n in range(1, 9)] == [2, 2, 4, 4, 6, 6, 8, 8]
        svc_p.stats["damc"].padded_items = 0
        svc_p._run("damc", [(item_draws(0, i, 8),) for i in range(3)])
        assert svc_p.stats["damc"].padded_items == 1
    finally:
        svc_j.close()
        svc_p.close()


def test_serve_cli_mesh_flags():
    argv = ["--dataset", "svhn", "--device", "cpu", "--max_batch", "4", "--nz", "8", "--ngf", "8", "--nif", "8",
            "--nxemb", "16", "--ntemb", "16", "--n_interval", "2", "--e_l_steps", "2"]
    svc, args = serve_cli.build_service(argv + ["--use_mesh"])
    try:
        assert args.use_mesh and svc.mesh is None and svc.device == torch.device("cpu")  # one device: a no-op
    finally:
        svc.close()
    with pytest.raises(SystemExit, match="single-process"):
        serve_cli.build_service(argv + ["--multihost"])
