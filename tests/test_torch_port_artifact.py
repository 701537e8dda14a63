"""The port's serving artifacts (`damc_tpu_torch/artifact.py`): export and
load, bit-for-bit parity with the live service, parity with the JAX
package's fused serving programs, meta validation, the CLI flags, the
kernels as `torch.ops.damc.*` nodes of the saved programs, and serving with
no model code imported. The counterpart of tests/test_artifact.py, at the
tiny svhn widths of `torch_port_helpers.tiny`, on the CPU (the ops' plain
versions)."""

from __future__ import annotations

import dataclasses
import json
import operator
import os
import subprocess
import sys
import threading
import types
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import damc_tpu.artifact as jax_artifact
from damc_tpu.serve import build_serving_fns as jax_serving_fns
from damc_tpu_torch import artifact
from damc_tpu_torch.artifact import export_serving_artifact, load_serving_artifact
from damc_tpu_torch.config import preset
from damc_tpu_torch.models import build_models
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from damc_tpu_torch.ops.cuda import fused_qsweep as k2
from damc_tpu_torch.serve import SamplerService, make_http_server
from test_torch_port_serve import _jax_draws
from torch_port_helpers import jax_and_port, one_torch_thread, tiny

REPO = Path(__file__).resolve().parents[1]
RECON_STEPS = 2
B = 4
TINY_FLAGS = [
    "--dataset", "svhn", "--nz", "8", "--ngf", "8", "--nif", "8", "--nxemb", "16", "--ntemb", "16",
    "--n_interval", "2", "--g_l_steps", "2", "--e_l_steps", "2", "--device", "cpu",
]
K1_OP = torch.ops.damc.fused_prior_langevin.default
K2_OP = torch.ops.damc.fused_reverse_sweep.default


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(jax cfg, jax state, jax models, port cfg, port models, live
    service, artifact dir, meta): one weight set on both sides."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=0)
    live = SamplerService(
        models_p, cfg_p, max_batch=B, window_ms=5.0, recon_langevin_steps=RECON_STEPS, device="cpu"
    )
    art_dir = tmp_path_factory.mktemp("artifact") / "svhn_tiny"
    meta = export_serving_artifact(
        models_p, cfg_p, art_dir, batch_size=B, recon_langevin_steps=RECON_STEPS, trained_step=7
    )
    yield cfg_j, state, models_j, cfg_p, models_p, live, art_dir, meta
    live.close()


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def test_export_writes_selfcontained_dir(setup):
    *_, art_dir, meta = setup
    assert (art_dir / "meta.json").is_file()
    for path in meta["paths"]:
        assert (art_dir / meta["files"][path]).stat().st_size > 0
    assert sorted(meta["paths"]) == ["damc", "ebm", "recon"]
    assert meta["batch_size"] == B and meta["format_version"] == 1
    assert meta["files"]["damc"] == f"damc_b{B}.pt2"
    assert meta["platforms"] == ["cpu", "cuda"] and meta["trained_step"] == 7
    assert meta["torch_version"] == torch.__version__ and meta["compute_dtype"] == "float32"
    assert meta["draws"] == "counter-v1" and meta["recon_langevin_steps"] == RECON_STEPS


def _assert_same_answers(svc, live):
    for prior in ("damc", "ebm"):
        np.testing.assert_array_equal(svc.sample(n=3, prior=prior, seed=42), live.sample(n=3, prior=prior, seed=42))
    x = _images(2)
    got_x, got_z = svc.reconstruct(x, seed=3)
    want_x, want_z = live.reconstruct(x, seed=3)
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_z, want_z)


def test_artifact_matches_live_service_bitwise(setup):
    """The loaded programs run the ops the live core dispatched, in the
    same order, on the same device: bit-identical answers."""
    *_, live, art_dir, _ = setup
    svc = SamplerService.from_artifact(art_dir, window_ms=5.0, device="cpu")
    try:
        assert sorted(svc.paths) == sorted(live.paths)
        assert svc.image_shape == live.image_shape and svc.nz == live.nz
        assert svc.max_batch == B and svc.deterministic and svc.artifact_meta["dataset"] == "svhn"
        _assert_same_answers(svc, live)
    finally:
        svc.close()


def test_artifact_service_deterministic_across_coalescing(setup):
    *_, art_dir, _ = setup
    svc = SamplerService.from_artifact(art_dir, window_ms=30.0, device="cpu")
    try:
        alone = svc.sample(n=1, prior="damc", seed=42)
        out = {}

        def hit(name, seed, n):
            out[name] = svc.sample(n=n, prior="damc", seed=seed)

        threads = [threading.Thread(target=hit, args=("a", 42, 1)), threading.Thread(target=hit, args=("b", 7, 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        np.testing.assert_array_equal(out["a"], alone)
        np.testing.assert_array_equal(svc.sample(n=3, prior="damc", seed=7), out["b"])
    finally:
        svc.close()


def _copy(art_dir, dst, files=True, **meta_edit):
    meta = json.loads((art_dir / "meta.json").read_text())
    meta.update(meta_edit)
    dst.mkdir()
    (dst / "meta.json").write_text(json.dumps(meta))
    if files:
        for f in meta["files"].values():
            (dst / f).write_bytes((art_dir / f).read_bytes())
    return dst


def test_meta_validation(setup, tmp_path):
    *_, art_dir, _ = setup
    with pytest.raises(ValueError, match="no meta.json"):
        load_serving_artifact(tmp_path, "cpu")
    with pytest.raises(ValueError, match="not a damc serving artifact"):
        load_serving_artifact(_copy(art_dir, tmp_path / "kind", kind="other"), "cpu")
    with pytest.raises(ValueError, match="format_version"):
        load_serving_artifact(_copy(art_dir, tmp_path / "version", format_version=999), "cpu")
    with pytest.raises(ValueError, match="draws scheme"):
        load_serving_artifact(_copy(art_dir, tmp_path / "draws", draws="threefry"), "cpu")
    with pytest.raises(ValueError, match="platforms"):
        load_serving_artifact(_copy(art_dir, tmp_path / "cuda_only", platforms=["cuda"]), "cpu")
    with pytest.raises(ValueError, match="missing program file"):
        load_serving_artifact(_copy(art_dir, tmp_path / "partial", files=False), "cpu")
    bad = _copy(art_dir, tmp_path / "corrupt", torch_version="0.0.1-exporter")
    (bad / f"damc_b{B}.pt2").write_bytes(b"not a program")
    with pytest.raises(RuntimeError, match=r"exported by torch 0\.0\.1-exporter"):
        load_serving_artifact(bad, "cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_serving_artifact(None, None, tmp_path / "tpu", platforms=("tpu",))
    fns, meta = load_serving_artifact(art_dir, "cpu")
    assert sorted(fns) == meta["paths"]


def test_cli_export_then_http_serve_from_artifact(tmp_path, capsys):
    """`cli.serve --export_artifact` writes a directory; an HTTP server over
    `--artifact` answers /healthz with source=artifact and serves /sample
    and /reconstruct."""
    from damc_tpu_torch.cli import serve as serve_cli

    art = tmp_path / "cli_art"
    serve_cli.main(TINY_FLAGS + ["--max_batch", "2", "--recon_langevin_steps", "2", "--artifact_platforms", "cpu",
                                 "--export_artifact", str(art)])
    meta = json.loads((art / "meta.json").read_text())
    assert meta["batch_size"] == 2 and meta["platforms"] == ["cpu"] and meta["recon_langevin_steps"] == 2
    svc, args = serve_cli.build_service(["--artifact", str(art), "--device", "cpu", "--bucketed"])
    assert "--bucketed is ignored with --artifact" in capsys.readouterr().out
    server = make_http_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["source"] == "artifact" and health["max_batch"] == 2
        for path, payload in (("/sample", {"n": 2, "prior": "damc", "seed": 1}),
                              ("/sample", {"n": 1, "prior": "ebm", "seed": 1}),
                              ("/reconstruct", {"image": _images(1)[0].tolist(), "seed": 1})):
            req = urllib.request.Request(base + path, data=json.dumps(payload).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read())
            shape = body["images"]["shape"] if path == "/sample" else body["x_hat"]["shape"]
            assert shape[-3:] == list(svc.image_shape)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
        svc.close()


def test_export_artifact_and_artifact_flags_exclusive():
    from damc_tpu_torch.cli import serve as serve_cli

    with pytest.raises(SystemExit, match="exclusive"):
        serve_cli.main(["--artifact", "x", "--export_artifact", "y"])


@pytest.mark.parametrize("path", ["damc", "ebm", "recon"])
def test_artifact_matches_jax_fused_serving(setup, path):
    """The loaded programs against `damc_tpu.serve.build_serving_fns(fused=
    True, fused_interpret="plain")`, fed the per-row draws the JAX programs
    derive from their keys. Tolerance 1e-4 on images in [-1, 1] (and on z),
    as test_torch_port_serve.py::test_serving_path_matches_jax holds the
    live core: fp32 on both sides, sums taken in other orders."""
    cfg_j, state, models_j, cfg_p, _, _, art_dir, _ = setup
    fns_j = jax_serving_fns(
        models_j, state.params_q, state.params_g, state.params_e, cfg_j,
        recon_langevin_steps=RECON_STEPS, fused=True, fused_interpret="plain",
    )
    fns_p, _ = load_serving_artifact(art_dir, "cpu")
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(B))
    draws = _jax_draws(path, keys, cfg_p.model.nz)
    if path == "recon":
        x = _images(B)
        want = [np.asarray(a) for a in jax.jit(fns_j[path][0])(keys, x)]
        got = [t.numpy() for t in fns_p[path](draws, torch.from_numpy(x))]
    else:
        want = [np.asarray(jax.jit(fns_j[path][0])(keys))]
        got = [fns_p[path](draws).numpy()]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("path,k1_nodes,k2_nodes", [("damc", 0, 1), ("ebm", 1, 0), ("recon", 0, 1)])
def test_saved_program_holds_the_kernel_ops(setup, path, k1_nodes, k2_nodes):
    """Each kernel is one `torch.ops.damc.*` node of the saved program (a
    trace of a bare ctypes launch would keep only its output's allocation),
    and no plain version was traced in: the graph holds no step of the
    counter-noise hash (`bitwise_xor`), which the draws run outside it."""
    *_, art_dir, meta = setup
    ep = torch.export.load(str(art_dir / meta["files"][path]))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(K1_OP) == k1_nodes and targets.count(K2_OP) == k2_nodes
    assert not any("bitwise_xor" in str(t) for t in targets)


def _k1_args(mode):
    r = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32) * 0.3)
    w = (t(8, 16), t(16), t(16, 16), t(16), t(16))
    seeds = torch.from_numpy(r.integers(0, 2**31 - 1, 3).astype(np.int32))
    noise = {"counter": (seeds, None, True), "stream": (None, 11, True), "noiseless": (None, None, False)}[mode]
    return (t(3, 8), *w, noise[0], noise[1], 3, 0.1, noise[2], "float32")


def _k2_args(mode):
    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params

    amort = build_models(tiny(preset("svhn")), seed=2, device="cpu").amortizer
    fourier, layers = denoiser_layer_params(amort.p)
    grid, coeffs = amort.step_tables("cpu")
    r = np.random.default_rng(4)
    normal = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))
    with torch.no_grad():
        tables = amort.p.sample_tables(grid, amort.prior_embed(normal(3, 8)))
    seeds = torch.from_numpy(r.integers(0, 2**31 - 1, 3).astype(np.int32))
    noise = {"counter": (seeds, None, True), "stream": (None, -5, True), "noiseless": (None, None, False)}[mode]
    flat = [t for lt in layers for t in lt]
    return (normal(3, 8), fourier, flat, tables["pre_x"], tables["pre_t"], coeffs, noise[0], noise[1], 2,
            noise[2], True)


@pytest.mark.parametrize("mode", ["counter", "stream", "noiseless"])
@pytest.mark.parametrize("op", ["K1", "K2"])
def test_opcheck(op, mode):
    """torch.library's own checks of each op's registration: schema (no
    input mutated), fake implementation (shape, dtype), autograd
    registration and the AOT dispatcher's trace."""
    args = _k1_args(mode) if op == "K1" else _k2_args(mode)
    torch.library.opcheck(K1_OP if op == "K1" else K2_OP, args)


def test_public_wrappers_are_the_ops():
    """The public functions reach the ops, whose CPU implementation is the
    plain version; a zero-step chain answers a copy, never its input."""
    args = _k1_args("counter")
    z, w = args[0], args[1:6]
    got = k1.fused_prior_langevin(z, *w, row_seeds=args[6], steps=3, step_size=0.1)
    assert torch.equal(got, K1_OP(*args))
    assert torch.equal(got, k1.prior_langevin_plain(z, *w, row_seeds=args[6], steps=3, step_size=0.1))
    zero = k1.fused_prior_langevin(z, *w, steps=0, with_noise=False)
    assert torch.equal(zero, z) and zero.data_ptr() != z.data_ptr()
    a = _k2_args("stream")
    layers = [tuple(a[2][i:i + 7]) for i in range(0, len(a[2]), 7)]
    got = k2.fused_reverse_sweep(a[0], a[1], layers, a[3], a[4], a[5], seed=-5, steps=2)
    assert torch.equal(got, K2_OP(*a))
    assert torch.equal(got, k2.reverse_sweep_plain(a[0], a[1], layers, a[3], a[4], a[5], seed=-5, steps=2))


def test_card_batch_norm_node_runs_on_the_cpu():
    """A program traced on the card records cuDNN's batch norm (the
    encoder's InstanceNorm); the loader's pass makes it
    `_batch_norm_impl_index`, so the program runs on the CPU and gives eager
    batch norm's values there."""
    aten = torch.ops.aten
    g = torch.fx.Graph()
    x, w, b = g.placeholder("x"), g.placeholder("w"), g.placeholder("b")
    bn = g.call_function(aten.cudnn_batch_norm.default, (x, w, b, None, None, True, 0.0, 1e-5))
    g.call_function(operator.getitem, (bn, 3))  # cuDNN's reserve space, read by nobody
    g.output(g.call_function(operator.getitem, (bn, 0)))
    gm = torch.fx.GraphModule(torch.nn.Module(), g)
    artifact._portable_batch_norm(gm)
    targets = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert targets == [aten._batch_norm_impl_index.default, operator.getitem]
    r = np.random.default_rng(6)
    xs, ws, bs = (torch.from_numpy(r.normal(size=s).astype(np.float32)) for s in ((1, 6, 5, 5), (6,), (6,)))
    want = torch.nn.functional.batch_norm(xs, None, None, ws, bs, training=True, momentum=0.0, eps=1e-5)
    assert torch.equal(gm(xs, ws, bs), want)


_SUBPROCESS = r"""
import json, sys, threading, urllib.request
from damc_tpu_torch.serve import SamplerService, make_http_server
from damc_tpu_torch.ops.cuda import fused_langevin, fused_qsweep
svc = SamplerService.from_artifact(sys.argv[1], device="cpu")
server = make_http_server(svc, "127.0.0.1", 0)
thread = threading.Thread(target=server.serve_forever, daemon=True)
thread.start()
base = "http://127.0.0.1:%d" % server.server_address[1]
def post(path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())
out = {
    "damc": post("/sample", {"n": 3, "prior": "damc", "seed": 42})["images"]["data"],
    "ebm": post("/sample", {"n": 2, "prior": "ebm", "seed": 9})["images"]["data"],
    "recon": post("/reconstruct", {"image": json.loads(sys.argv[2]), "seed": 3})["x_hat"]["data"],
}
server.shutdown(); server.server_close(); svc.close()
out["imported"] = sorted(m for m in sys.modules if m.startswith(("damc_tpu_torch.models", "damc_tpu_torch.train")))
out["launches"] = [fused_langevin.fused_prior_langevin.launches, fused_qsweep.fused_reverse_sweep.launches]
print(json.dumps(out))
"""


def test_subprocess_serves_without_model_code(setup):
    """A fresh interpreter serves the artifact over HTTP importing only the
    serving and artifact modules (and through them the ops): no model or
    training module is imported, and the answers are the live service's."""
    *_, live, art_dir, _ = setup
    x = _images(1, seed=5)[0]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(art_dir), json.dumps(x.tolist())],
                         capture_output=True, text=True, env=env, timeout=300, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["imported"] == [] and out["launches"] == [0, 0]  # the CPU runs the plain versions
    np.testing.assert_array_equal(np.asarray(out["damc"], np.float32), live.sample(3, "damc", 42))
    np.testing.assert_array_equal(np.asarray(out["ebm"], np.float32), live.sample(2, "ebm", 9))
    np.testing.assert_array_equal(np.asarray(out["recon"], np.float32), live.reconstruct(x, 3)[0])


def test_bf16_artifact_matches_live(tmp_path):
    """With compute_dtype bfloat16 the bf16 G and encoder are baked into the
    programs; the artifact still answers the live service's bits."""
    edit = lambda c: dataclasses.replace(c, model=dataclasses.replace(c.model, compute_dtype="bfloat16"))
    cfg = edit(tiny(preset("svhn")))
    models = build_models(cfg, seed=3, device="cpu")
    live = SamplerService(models, cfg, max_batch=2, recon_langevin_steps=RECON_STEPS, device="cpu")
    meta = export_serving_artifact(models, cfg, tmp_path / "bf16", batch_size=2, recon_langevin_steps=RECON_STEPS)
    assert meta["compute_dtype"] == "bfloat16"
    svc = SamplerService.from_artifact(tmp_path / "bf16", device="cpu")
    try:
        _assert_same_answers(svc, live)
    finally:
        svc.close()
        live.close()


def test_meta_keys_match_jax(setup, tmp_path, monkeypatch):
    """The port's meta.json has JAX's keys but four: `torch_version` for
    `jax_version`, `draws` for the PRNG key layout (`prng_impl`,
    `key_shape`, `key_dtype`), and `compute_dtype` and `fused` (the serving
    route the programs hold; JAX's artifacts always hold its unfused route)
    added. JAX's own meta writer runs, with its lowering stubbed (the keys
    need no program)."""
    cfg_j, state, models_j, *_, meta = setup
    stub = lambda fn, platforms: lambda *specs: types.SimpleNamespace(serialize=lambda: b"")
    monkeypatch.setattr(jax_artifact.jax.export, "export", stub)
    jax_meta = jax_artifact.export_serving_artifact(
        state, models_j, cfg_j, tmp_path, batch_size=B, recon_langevin_steps=RECON_STEPS, platforms=("cpu",)
    )
    swapped = {"jax_version", "prng_impl", "key_shape", "key_dtype"}
    assert set(meta) == set(jax_meta) - swapped | {"torch_version", "draws", "compute_dtype", "fused"}
    for key in set(meta) & set(jax_meta) - {"files", "platforms", "trained_step"}:
        assert meta[key] == jax_meta[key], key
