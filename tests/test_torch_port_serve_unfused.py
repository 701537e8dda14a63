"""The port's unfused serving route (`build_serving_fns(fused=False)`,
`SamplerService(fused=)`, `cli.serve --fused`): the sweep as the torch loop
over the denoiser's step tables and the EBM chain by autograd, each step's
noise the per-row counter normals the kernels draw.

Held on the CPU against the JAX package's fused serving programs fed the
same draws (JAX's kernels through `interpret="plain"`), against the port's
fused route, and, noiseless, against JAX's own unfused (scan) programs; the
static route rule on every preset and on models the kernels refuse; the
per-request contract on both routes; the CLI flag; an unfused serving
artifact. Tolerance 1e-4 on images in [-1, 1] and on z, as
test_torch_port_serve.py holds the fused route: float32 on both sides,
the sums of the products, the convolutions and the chains' autograd taken
in other orders."""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.serve import build_serving_fns as jax_serving_fns
from damc_tpu_torch.artifact import export_serving_artifact
from damc_tpu_torch.config import preset
from damc_tpu_torch.models import DAMCAmortizer, LatentEBM, ModelBundle, build_models, make_generator
from damc_tpu_torch.models import ToyGenerator
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from damc_tpu_torch.ops.cuda import fused_qsweep as k2
from damc_tpu_torch.serve import RowDraws, SamplerService, build_serving_fns, item_draws, serving_fused_auto
from damc_tpu_torch.serve import stack_draws
from test_torch_port_serve import _jax_draws
from torch_port_helpers import jax_and_port, one_torch_thread, tiny

RECON_STEPS = 2
ATOL = 1e-4  # module docstring
PATHS = ["damc", "ebm", "recon"]
TINY_FLAGS = [
    "--dataset", "svhn", "--ngf", "8", "--nif", "8", "--nxemb", "16", "--ntemb", "16",
    "--n_interval", "2", "--g_l_steps", "2", "--e_l_steps", "2", "--device", "cpu",
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def setup():
    return jax_and_port(seed=0)


def _x(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _run(fns, path, draws, x):
    if path == "recon":
        return [t.numpy() for t in fns[path](draws, torch.from_numpy(x))]
    return [fns[path](draws).numpy()]


def _keys(n=4):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(n))


@pytest.mark.parametrize("path", PATHS)
def test_unfused_path_matches_jax_fused_serving(setup, path):
    """Each path of the unfused route against JAX's `build_serving_fns(fused=
    True, fused_interpret="plain")`, fed the per-row draws the JAX program
    derives from its keys: the sweep's and the chain's step noise are the
    counter normals JAX's kernels draw in-kernel for the same seeds."""
    cfg_j, state, models_j, cfg_p, models_p = setup
    fns_j = jax_serving_fns(
        models_j, state.params_q, state.params_g, state.params_e, cfg_j,
        recon_langevin_steps=RECON_STEPS, fused=True, fused_interpret="plain",
    )
    fns_p = build_serving_fns(models_p, cfg_p, RECON_STEPS, fused=False)
    keys, x = _keys(), _x(4)
    draws = _jax_draws(path, keys, cfg_p.model.nz)
    want = jax.jit(fns_j[path][0])(*((keys, x) if path == "recon" else (keys,)))
    want = [np.asarray(a) for a in (want if path == "recon" else (want,))]
    for g, w in zip(_run(fns_p, path, draws, x), want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("path", PATHS)
def test_port_routes_agree(setup, path):
    """The port's two routes on the same `item_draws`: the kernels' plain
    versions against the unfused loops, each step on the same normals; and
    the unfused route launches neither kernel's op."""
    *_, cfg_p, models_p = setup
    fused = build_serving_fns(models_p, cfg_p, RECON_STEPS, fused=True)
    unfused = build_serving_fns(models_p, cfg_p, RECON_STEPS, fused=False)
    draws = stack_draws([item_draws(9, i, cfg_p.model.nz) for i in range(4)], "cpu")
    x = _x(4, seed=3)
    before = (k1.fused_prior_langevin.launches, k2.fused_reverse_sweep.launches)
    got = _run(unfused, path, draws, x)
    for g, w in zip(got, _run(fused, path, draws, x)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    assert (k1.fused_prior_langevin.launches, k2.fused_reverse_sweep.launches) == before


def test_ebm_noiseless_matches_jax_unfused():
    """The noiseless `ebm` path (e_l_with_noise False) against JAX's
    `fused=False` program (vmap of single scan chains), pointwise, from the
    z0 each JAX item draws from its key (`damc_tpu/serve.py:398-406`)."""
    noiseless = lambda c: dataclasses.replace(c, mcmc=dataclasses.replace(c.mcmc, e_l_with_noise=False))
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=1, edit=noiseless)
    fns_j = jax_serving_fns(models_j, state.params_q, state.params_g, state.params_e, cfg_j, fused=False)
    keys = _keys()
    nz = cfg_p.model.nz
    z0 = jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[0], (1, nz))[0])(keys)
    zeros = torch.zeros(4, nz)
    seeds = torch.zeros(4, dtype=torch.int32)
    draws = RowDraws(torch.from_numpy(np.array(z0)), zeros, seeds, seeds)
    got = build_serving_fns(models_p, cfg_p, fused=False)["ebm"](draws).numpy()
    want = np.asarray(jax.jit(fns_j["ebm"][0])(keys))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _meta_models(cfg):
    """The models of `cfg` on the meta device (shapes only), for the static
    route rule at full width."""
    m, d = cfg.model, cfg.diffusion
    with torch.device("meta"):
        toy = m.dataset == "toy"
        return ModelBundle(
            generator=ToyGenerator(in_dim=m.nz) if toy else make_generator(m.dataset, ngf=m.ngf, nc=m.nc, nz=m.nz),
            ebm=None if toy else LatentEBM(m.nz, ndf=m.ndf),
            amortizer=DAMCAmortizer(nz=m.nz, nxemb=m.nxemb, ntemb=m.ntemb, nf=m.nf, nif=m.nif, nc=m.nc,
                                    dataset=m.dataset, n_interval=d.n_interval),
        )


def _widths(cfg, **model):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


@pytest.mark.parametrize("name", ["cifar10", "svhn", "celeba64", "celebaHQ", "mnist_anomaly", "toy"])
def test_serving_fused_auto_takes_every_preset(name):
    assert serving_fused_auto(_meta_models(preset(name)))


@pytest.mark.parametrize("case,fits", [
    ("ndf_12", True), ("ndf_10", True), ("ndf_512", True), ("nz_10", True), ("ebm_3_hidden", False),
    ("denoiser_nf_5", False),
])
def test_serving_fused_auto_refuses_what_a_kernel_refuses(case, fits):
    """cifar10 at full width with one change: K1 takes every 2-hidden EBM,
    as the TPU kernel does (ndf 12 as it is; ndf 10 and nz 10 zero-padded,
    ndf 512 with its weights read from L2), while a 3-hidden EBM is not the
    layout K1 hand-codes, and nf 5 makes the denoiser's wide layers 320
    columns, more than K2's 256."""
    cfg = preset("cifar10")
    edit = {"ndf_12": dict(ndf=12), "ndf_10": dict(ndf=10), "ndf_512": dict(ndf=512), "nz_10": dict(nz=10),
            "ebm_3_hidden": {}, "denoiser_nf_5": dict(nf=5)}[case]
    models = _meta_models(_widths(cfg, **edit))
    if case == "ebm_3_hidden":
        with torch.device("meta"):
            models.ebm = LatentEBM(cfg.model.nz, ndf=cfg.model.ndf, n_hidden=3)
    assert serving_fused_auto(models) is fits


def _refused(kind):
    """A tiny svhn model one kernel refuses: K1 (a 3-hidden EBM) or K2 (nf 5)."""
    cfg = tiny(preset("svhn"))
    if kind == "K1":
        models = build_models(cfg, seed=2, device="cpu")
        torch.manual_seed(2)
        models.ebm = LatentEBM(cfg.model.nz, ndf=cfg.model.ndf, n_hidden=3)
        return models, cfg
    cfg = _widths(cfg, nf=5)
    return build_models(cfg, seed=2, device="cpu"), cfg


@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_fused_route_raises_for_refused_models(kind):
    models, cfg = _refused(kind)
    with pytest.raises(ValueError, match="fits_ebm" if kind == "K1" else "fits_smem"):
        SamplerService(models, cfg, max_batch=2, device="cpu", fused=True)
    svc = SamplerService(models, cfg, max_batch=2, device="cpu")
    try:
        assert svc.fused is False
        assert np.isfinite(svc.sample(n=2, prior="ebm", seed=1)).all()
    finally:
        svc.close()


def _coalescing(svc, nz):
    """An item alone equals it coalesced, on every path."""
    for prior in ("damc", "ebm"):
        alone = svc.sample(n=1, prior=prior, seed=11)
        out = {}

        def go(k, seed):
            out[k] = svc.sample(n=3, prior=prior, seed=seed)

        threads = [threading.Thread(target=go, args=(k, s)) for k, s in ((0, 11), (1, 12))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        assert np.array_equal(out[0][0], alone[0]), prior
        assert not np.array_equal(out[0][0], out[0][1])
    x = _x(3, seed=1)
    x_hat, z = svc.reconstruct(x, seed=4)
    x1, z1 = svc.reconstruct(x[0], seed=4)
    assert z.shape == (3, nz)
    assert np.array_equal(x_hat[0], x1) and np.array_equal(z[0], z1)


@pytest.mark.parametrize("route", ["unfused", "fused", "auto_refused"])
def test_item_alone_equals_coalesced(route):
    if route == "auto_refused":
        models, cfg = _refused("K1")
        fused = None
    else:
        cfg = tiny(preset("svhn"))
        models, fused = build_models(cfg, seed=1, device="cpu"), route == "fused"
    svc = SamplerService(models, cfg, max_batch=4, window_ms=30.0, recon_langevin_steps=RECON_STEPS,
                         device="cpu", fused=fused)
    try:
        assert svc.fused is (route == "fused")
        _coalescing(svc, cfg.model.nz)
    finally:
        svc.close()


def test_cli_fused_flag(capsys, tmp_path):
    """`--fused` parses and reaches the service; `auto` serves nz 10 on the
    kernels (K1 pads it) and a model K2 refuses (nz 300: the denoiser's
    layers past its 256 columns) on the unfused route, `on` refuses that
    one naming the fit rule; `--fused` with `--artifact` is ignored with a
    warning and the artifact served on its own route, as JAX's CLI does
    (`damc_tpu/cli/serve.py:93-101`)."""
    from damc_tpu_torch.cli import serve as serve_cli

    assert serve_cli.parse_args(["--fused", "off"]).fused == "off"
    assert serve_cli.parse_args([]).fused == "auto"
    with pytest.raises(SystemExit):
        serve_cli.parse_args(["--fused", "maybe"])
    art = str(tmp_path / "art")
    serve_cli.export_artifact(serve_cli.parse_args(TINY_FLAGS + ["--nz", "8", "--max_batch", "2",
                                                                 "--export_artifact", art]))
    svc, _ = serve_cli.build_service(["--artifact", art, "--fused", "off", "--device", "cpu"])
    try:
        assert svc.fused is True  # the artifact's route, not the flag's
        assert svc.sample(n=1, prior="ebm", seed=3).shape == (1, 32, 32, 3)
    finally:
        svc.close()
    assert "[damc] WARNING: --fused is ignored with --artifact (baked into the exported program)" in (
        capsys.readouterr().out)
    for flags, fused in ((["--nz", "8", "--fused", "off"], False), (["--nz", "8"], True), (["--nz", "10"], True),
                         (["--nz", "300"], False)):
        svc, _ = serve_cli.build_service(TINY_FLAGS + flags)
        try:
            assert svc.fused is fused
            assert svc.sample(n=1, prior="ebm", seed=3).shape == (1, 32, 32, 3)
        finally:
            svc.close()
    out = capsys.readouterr().out
    assert "route: unfused torch loops, no kernel (--fused off)" in out
    assert "route: fused kernels K1 and K2 (--fused auto)" in out
    assert "route: unfused torch loops, no kernel (--fused auto)" in out
    with pytest.raises(ValueError, match="fits_smem"):
        serve_cli.build_service(TINY_FLAGS + ["--nz", "300", "--fused", "on"])


def test_unfused_artifact_matches_live_bitwise(setup, tmp_path):
    """`export_serving_artifact(fused=False)` traces the unfused route: the
    meta records it, the programs hold no kernel op, and the loaded service
    answers bit for bit as the live unfused service."""
    *_, cfg_p, models_p = setup
    meta = export_serving_artifact(models_p, cfg_p, tmp_path / "art", batch_size=4,
                                   recon_langevin_steps=RECON_STEPS, fused=False)
    assert meta["fused"] is False
    for path in meta["paths"]:
        ep = torch.export.load(str(tmp_path / "art" / meta["files"][path]))
        targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
        assert not any("damc." in t for t in targets), path
    live = SamplerService(models_p, cfg_p, max_batch=4, recon_langevin_steps=RECON_STEPS, device="cpu",
                          fused=False)
    art = SamplerService.from_artifact(tmp_path / "art", device="cpu")
    try:
        assert art.fused is False and live.fused is False
        for prior in ("damc", "ebm"):
            np.testing.assert_array_equal(art.sample(n=3, prior=prior, seed=42),
                                          live.sample(n=3, prior=prior, seed=42))
        x = _x(2)
        for a, b in zip(art.reconstruct(x, seed=3), live.reconstruct(x, seed=3)):
            np.testing.assert_array_equal(a, b)
    finally:
        art.close()
        live.close()
