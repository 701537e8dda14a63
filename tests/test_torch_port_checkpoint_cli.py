"""The port's checkpoint CLIs (`damc_tpu_torch/cli/convert_checkpoint.py`,
`cli/export_checkpoint.py`) against the JAX package's CLIs of those names,
on the same files: a reference-format `.pth.tar` in, a training checkpoint
out (G, E, Q, Q_ema from `Q_dummy_state_dict`, the iteration; fresh Adam),
and back. The JAX CLIs read `preset(--dataset)` alone, so their runs here
take the tiny widths through a patched `damc_tpu.utils.config.preset`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import damc_tpu.utils.config as jax_config
from damc_tpu.cli import convert_checkpoint as jax_convert_cli
from damc_tpu.cli import export_checkpoint as jax_export_cli
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from damc_tpu.utils.checkpoint import save_checkpoint as jax_save
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu.utils.torch_compat import export_reference_checkpoint
from damc_tpu_torch.cli import convert_checkpoint, export_checkpoint
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import amortizer_state, state_dicts_from_jax, train_state_from_jax
from damc_tpu_torch.models import build_models
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.utils.checkpoint import FILE, restore_checkpoint, save_checkpoint
from torch_port_helpers import one_torch_thread, tiny, to_numpy

STEP = 42
WIDTHS = ["--ngf", "8", "--nif", "8", "--nxemb", "16", "--ntemb", "16", "--n_interval", "2",
          "--g_l_steps", "2", "--e_l_steps", "2"]


def _flags(dataset):
    return ["--dataset", dataset, "--device", "cpu", *WIDTHS] + (["--nz", "8"] if dataset != "toy" else [])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture
def tiny_jax_preset(monkeypatch):
    monkeypatch.setattr(jax_config, "preset", lambda name: tiny(jax_preset(name)))


def _jax_state(dataset):
    """A tiny JAX state at iteration STEP whose Q_ema differs from Q."""
    state, _, _ = jax_create_state(jax.random.PRNGKey(4), tiny(jax_preset(dataset)))
    ema = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.25, state.params_q_ema)
    return state.replace(step=jnp.int32(STEP), params_q_ema=ema)


def _payload(path):
    return torch.load(f"{path}/{FILE}", map_location="cpu", weights_only=True)


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k].to(torch.float32)), k


@pytest.mark.parametrize("dataset", ["svhn", "toy"])
def test_convert_matches_jax_cli(tmp_path, tiny_jax_preset, dataset):
    """A reference `.pth.tar` through both convert CLIs: the port's
    checkpoint holds exactly the JAX checkpoint's weights (its
    `state_dicts_from_jax`), Q_ema from Q_dummy included, the iteration, and
    fresh optimizers; `--resume_path` restores it."""
    state = _jax_state(dataset)
    pth = str(tmp_path / "ref.pth.tar")
    export_reference_checkpoint(state, pth, dataset, nxemb=16)

    jax_convert_cli.main(["--dataset", dataset, "--torch_ckpt", pth, "--out_dir", str(tmp_path / "jax")])
    template, _, _ = jax_create_state(jax.random.PRNGKey(0), tiny(jax_preset(dataset)))
    jax_state = to_numpy(jax_restore(str(tmp_path / "jax"), str(STEP), template))
    want = state_dicts_from_jax(
        {"params_g": jax_state.params_g, "params_e": jax_state.params_e, "params_q": jax_state.params_q}
    )
    want_ema = {k: torch.from_numpy(np.array(v)) for k, v in amortizer_state(jax_state.params_q_ema, 16).items()}

    path = convert_checkpoint.main(
        _flags(dataset) + ["--torch_ckpt", pth, "--out_dir", str(tmp_path / "port")]
    )
    saved = _payload(path)
    assert saved["step"] == int(jax_state.step) == STEP
    _assert_dicts_equal(saved["generator"], want["generator"])
    _assert_dicts_equal(saved["amortizer"], want["amortizer"])
    _assert_dicts_equal(saved["amortizer_ema"], want_ema)
    assert not torch.equal(saved["amortizer_ema"]["prior_emb.0.weight"], saved["amortizer"]["prior_emb.0.weight"])
    if dataset == "toy":
        assert saved["ebm"] is None and "ebm" not in want
    else:
        _assert_dicts_equal(saved["ebm"], want["ebm"])
    for opt in ("opt_g", "opt_e", "opt_q"):
        if saved[opt] is not None:
            assert saved[opt]["count"] == 0 and saved[opt]["torch"]["state"] == {}
    cfg = tiny(preset(dataset))
    resumed = restore_checkpoint(str(tmp_path / "port"), str(STEP), create_state(cfg, 0, "cpu"))
    assert resumed.step == STEP


@pytest.mark.parametrize("dataset", ["svhn", "toy"])
def test_export_matches_jax_cli_and_loads_strictly(tmp_path, tiny_jax_preset, dataset):
    """One training state, as a JAX checkpoint and as the port's
    (`train_state_from_jax`), through both export CLIs: the two files hold
    the same keys and tensors and the same iter, and every state dict loads
    strictly into the port's (reference-layout) networks. The toy's has no
    E."""
    state = _jax_state(dataset)
    jax_save(str(tmp_path / "jax"), str(STEP), state)
    pth_j = str(tmp_path / "jax.pth.tar")
    jax_export_cli.main(["--dataset", dataset, "--ckpt", str(tmp_path / "jax" / str(STEP)), "--out", pth_j])

    cfg = tiny(preset(dataset))
    port = train_state_from_jax(to_numpy(state), cfg, device="cpu")
    save_checkpoint(str(tmp_path / "port"), str(STEP), port)
    pth_p = str(tmp_path / "port.pth.tar")
    export_checkpoint.main(["--ckpt", str(tmp_path / "port" / str(STEP)), "--out", pth_p])

    got = torch.load(pth_p, map_location="cpu", weights_only=True)
    want = torch.load(pth_j, map_location="cpu", weights_only=True)
    assert set(got) == set(want) and got["iter"] == want["iter"] == STEP
    assert ("E_state_dict" in got) == (dataset != "toy")
    for key in set(want) - {"iter"}:
        _assert_dicts_equal(got[key], want[key])
    models = build_models(cfg, seed=9, device="cpu")
    models.generator.load_state_dict(got["G_state_dict"], strict=True)
    models.amortizer.load_state_dict(got["Q_state_dict"], strict=True)
    models.amortizer.load_state_dict(got["Q_dummy_state_dict"], strict=True)
    if models.ebm is not None:
        models.ebm.load_state_dict(got["E_state_dict"], strict=True)


@pytest.mark.parametrize("dataset", ["svhn", "toy"])
def test_convert_after_export_gives_the_state_back(tmp_path, dataset):
    """Port checkpoint -> export -> convert: the same G, E, Q, Q_ema and
    iteration (the optimizers restart, as the reference format has none)."""
    cfg = tiny(preset(dataset))
    state = create_state(cfg, 3, "cpu")
    state.step = STEP
    with torch.no_grad():
        for p in state.amortizer_ema.parameters():
            p.mul_(0.5)
    save_checkpoint(str(tmp_path / "a"), str(STEP), state)
    pth = str(tmp_path / "x.pth.tar")
    export_checkpoint.main(["--ckpt", str(tmp_path / "a" / str(STEP)), "--out", pth])
    back = _payload(convert_checkpoint.main(_flags(dataset) + ["--torch_ckpt", pth, "--out_dir", str(tmp_path / "b"),
                                                               "--name", "back"]))
    orig = _payload(tmp_path / "a" / str(STEP))
    assert back["step"] == STEP
    for part in ("generator", "amortizer", "amortizer_ema", "ebm"):
        if orig[part] is None:
            assert back[part] is None and dataset == "toy"
        else:
            _assert_dicts_equal(back[part], orig[part])


def test_export_refuses_a_checkpoint_without_the_gen_recon_parts(tmp_path):
    """A StyleGAN inversion checkpoint (G, E and Q_ema saved as None) has no
    reference `.pth.tar` form."""
    cfg = tiny(preset("svhn"))
    state = create_state(cfg, 0, "cpu")
    save_checkpoint(str(tmp_path), "1", state)
    saved = _payload(tmp_path / "1")
    saved["generator"] = saved["amortizer_ema"] = None
    torch.save(saved, tmp_path / "1" / FILE)
    with pytest.raises(ValueError, match="lacks"):
        export_checkpoint.main(["--ckpt", str(tmp_path / "1"), "--out", str(tmp_path / "x.pth.tar")])
