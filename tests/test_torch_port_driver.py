"""The port's training driver (`damc_tpu_torch/train/{driver_utils,
gen_recon}.py`, `utils/logging.py`) on the CPU: the CD-gap monitor and the
resume helpers against `damc_tpu/train/driver_utils.py`, the recon-MSE eval
against `damc_tpu/train/gen_recon.py::evaluate_mse` on a set that batches
do not divide, a short run with logs, evals, grids and checkpoints,
preemption by SIGTERM with `resume_path="auto"`, and the PNG grids against
the JAX package's PIL files pixel for pixel."""

from __future__ import annotations

import dataclasses
import io
import json
import os
import signal

import jax
import numpy as np
import pytest
from PIL import Image

from damc_tpu.train import driver_utils as jax_driver
from damc_tpu.train.gen_recon import evaluate_mse as jax_evaluate_mse
from damc_tpu.utils.logging import save_image_grid as jax_save_image_grid
from damc_tpu_torch.config import preset
from damc_tpu_torch.metrics.fid import make_random_feature_fn
from damc_tpu_torch.train import driver_utils
from damc_tpu_torch.train.gen_recon import evaluate_mse, train_gen_recon
from damc_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint
from damc_tpu_torch.utils.logging import PNG_SIGNATURE, MetricsLogger, save_image_grid
from test_torch_port_sampling import noiseless, recon_draws
from torch_port_helpers import jax_and_port, tiny
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


def _gap_rows(seq):
    return [{"e_pos": g, "e_neg": 0.0, "g_loss": 1.0} for g in seq]


GAPS = {
    "quiet": [0.1, -0.12, 0.11] * 10,
    "runaway": [0.1] * 20 + [0.2, 3.0, 5.5, 6.0, 0.1],
    "tiny_base": [0.0] * 20 + [0.04, 0.06],
    "ceiling": [1.0] * 20 + [60.0, 900.0, 30000.0],
}


@pytest.mark.parametrize("name", list(GAPS))
@pytest.mark.parametrize("ceiling", [None, 2e-4])
def test_cd_gap_monitor_matches_jax(name, ceiling):
    alpha = ceiling or 0.0
    assert driver_utils.cd_gap_ceiling(alpha) == jax_driver.cd_gap_ceiling(alpha)
    a = jax_driver.CDGapMonitor(gap_ceiling=jax_driver.cd_gap_ceiling(alpha))
    b = driver_utils.CDGapMonitor(gap_ceiling=driver_utils.cd_gap_ceiling(alpha))
    for it, row in enumerate(_gap_rows(GAPS[name])):
        assert b.update(it, row, quiet=True) == a.update(it, row, quiet=True)
    assert b.fired_at == a.fired_at
    assert b.update(99, {"g_loss": 1.0}) == a.update(99, {"g_loss": 1.0}) == {}


def test_cd_gap_monitor_seeds_from_history_as_jax(tmp_path):
    path = tmp_path / "metrics.jsonl"
    rows = [{"step": i, "phase": "train", **r} for i, r in enumerate(_gap_rows(GAPS["runaway"]))]
    rows.insert(3, {"step": 3, "phase": "eval", "recon_mse": 0.1})
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
        f.write('{"step": 40, "phase": "tr')  # torn tail line
    for upto in (10, 22, 100):
        a, b = jax_driver.CDGapMonitor(), driver_utils.CDGapMonitor()
        a.seed_from_history(str(path), upto)
        b.seed_from_history(str(path), upto)
        assert (b.fired_at, b._warm) == (a.fired_at, a._warm)
        assert b.update(upto, _gap_rows([7.0])[0]) == a.update(upto, _gap_rows([7.0])[0])
    driver_utils.CDGapMonitor().seed_from_history(str(tmp_path / "none.jsonl"), 5)


def test_cd_history_path_and_resume_path_match_jax(tmp_path):
    run = tmp_path / "run"
    (run / "ckpt" / "7").mkdir(parents=True)
    (run / "ckpt" / "12").mkdir()
    (run / "ckpt" / "best").mkdir()
    (run / "metrics.jsonl").write_text('{"step": 0}\n')
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    empty = fresh / "metrics.jsonl"
    empty.write_text("")
    cases = [
        (str(run / "metrics.jsonl"), "auto"),
        (str(empty), str(run / "ckpt" / "7")),
        (str(empty), str(run / "ckpt" / "7") + "/"),
        (str(empty), "auto"),
        (None, None),
        (str(fresh / "absent.jsonl"), str(tmp_path / "other" / "ckpt" / "3")),
    ]
    for logger_path, resume in cases:
        assert driver_utils.cd_history_path(logger_path, resume) == jax_driver.cd_history_path(logger_path, resume)
    ckpt = str(run / "ckpt")
    for resume in ("auto", None, str(run / "ckpt" / "7")):
        assert driver_utils.resolve_resume_path(resume, ckpt) == jax_driver.resolve_resume_path(resume, ckpt)
    assert driver_utils.resolve_resume_path("auto", str(fresh)) is None


def test_evaluate_mse_matches_jax_on_a_ragged_set():
    """13 images in batches of 4: three full batches and a tail of 1, which
    the JAX package pads to 4 and the port runs at its size; both divide
    the sum over the 13 real images by 13 (rtol 1e-5)."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=6, edit=noiseless)
    x = np.random.default_rng(8).uniform(-1, 1, (13, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jax_evaluate_mse(key, state, models_j, cfg_j, x, 4)
    nz = cfg_p.model.nz
    sizes = []

    def draws(i, b):
        sizes.append(b)
        d = recon_draws(jax.random.fold_in(key, 4 * i), 4, nz)  # the JAX loop folds in the offset
        return dataclasses.replace(d, z0=d.z0[:b], emb_noise=d.emb_noise[:b])

    got = evaluate_mse(models_p, cfg_p, x, 4, draws)
    assert sizes == [4, 4, 4, 1]
    assert got == pytest.approx(want, rel=1e-5)
    with pytest.raises(ValueError, match="empty"):
        evaluate_mse(models_p, cfg_p, x[:0], 4, draws)


def _cfg(**train_kw):
    cfg = tiny(preset("svhn"))
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=4, q_updates=2, n_fid_samples=8,
                                       fid_batch_size=4, **train_kw),
    )


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_three_iterations_with_logs_evals_grids_and_checkpoints(tmp_path):
    """Evals at 0 and 2 (eval_every 2, and 2 is the last), plots at 0 and
    2, the terminal checkpoint ckpt/2 and `best` from the first eval."""
    cfg = _cfg(eval_every=2, plot_every=2, ckpt_every=5, print_every=1)
    imgs = _images(16)
    mse = imgs[:6].astype(np.float32) / 127.5 - 1.0
    feat = make_random_feature_fn((32, 32, 3), dim=16)
    log_dir = str(tmp_path)
    state = train_gen_recon(cfg, imgs, iterations=3, seed=2, device="cpu", fid_images=imgs,
                            mse_images=mse, feature_fn=feat, log_dir=log_dir, fid_metric_name="frechet_rand")
    assert state.step == 3
    rows = _rows(log_dir)
    assert [r["step"] for r in rows if r["phase"] == "train"] == [0, 1, 2]
    evals = [r for r in rows if r["phase"] == "eval"]
    assert [r["step"] for r in evals] == [0, 2]
    for r in evals:
        assert list(r)[:3] == ["step", "wall_s", "phase"]
        for k in ("frechet_rand_damc", "frechet_rand_ebm", "recon_mse", "recon_mse_best", "frechet_rand_best"):
            assert np.isfinite(r[k]), k
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "best"]
    assert latest_step(str(tmp_path / "ckpt")) == 2
    grids = sorted(os.listdir(tmp_path / "imgs"))
    kinds = ("obs", "post", "post_Q", "prior", "fid_damc", "fid_ebm")
    assert grids == sorted(f"{it}_{k}.png" for it in (0, 2) for k in kinds)
    for g in grids:
        with open(tmp_path / "imgs" / g, "rb") as f:
            assert f.read(8) == PNG_SIGNATURE
    # The terminal checkpoint holds the returned state.
    from damc_tpu_torch.train.state import create_state
    from test_torch_port_checkpoint import assert_states_equal

    assert_states_equal(restore_checkpoint(str(tmp_path / "ckpt"), "2", create_state(cfg, device="cpu")), state)


def test_sigterm_checkpoints_and_auto_resume_continues(tmp_path, capsys):
    """SIGTERM sent from the callback of iteration 1 stops the run at the
    next boundary with ckpt/2 (state.step 2); a relaunch with
    resume_path='auto' continues at iteration 2 and appends to the same
    metrics file. ckpt_every 0: no other checkpoint is written."""
    cfg = _cfg(eval_every=0, plot_every=0, ckpt_every=0, print_every=1)
    imgs = _images(16, seed=3)
    seen = []
    before = signal.getsignal(signal.SIGTERM)

    def on_step(it, state, metrics):
        seen.append(it)
        if it == 1:
            handler = signal.getsignal(signal.SIGTERM)
            assert handler not in (signal.SIG_DFL, signal.SIG_IGN), "the loop's handler is not installed"
            signal.raise_signal(signal.SIGTERM)

    log_dir = str(tmp_path)
    state = train_gen_recon(cfg, imgs, iterations=5, seed=4, device="cpu", log_dir=log_dir, on_step=on_step)
    assert seen == [0, 1] and state.step == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]
    out = capsys.readouterr().out
    assert f"signal {int(signal.SIGTERM)}: checkpointed to {tmp_path / 'ckpt' / '2'}" in out

    seen.clear()
    state = train_gen_recon(cfg, imgs, iterations=4, seed=4, device="cpu", log_dir=log_dir,
                            resume_path="auto", on_step=lambda it, st, m: seen.append((it, st.step)))
    assert seen == [(2, 3), (3, 4)] and state.step == 4
    assert f"resumed from {tmp_path / 'ckpt' / '2'} at iteration 2" in capsys.readouterr().out
    assert [r["step"] for r in _rows(log_dir)] == [0, 1, 2, 3]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]
    assert signal.getsignal(signal.SIGTERM) == before  # the loop put the handler back


def test_metrics_logger_rows_match_jax(tmp_path, capsys):
    from damc_tpu.utils.logging import MetricsLogger as JaxLogger

    for cls, sub in ((JaxLogger, "jax"), (MetricsLogger, "port")):
        log = cls(str(tmp_path / sub))
        log.log(3, {"a": np.float32(1.5), "b": 2}, prefix="eval")
    rows = {sub: json.loads(open(tmp_path / sub / "metrics.jsonl").read()) for sub in ("jax", "port")}
    for r in rows.values():
        r.pop("wall_s")
    assert rows["port"] == rows["jax"] == {"step": 3, "phase": "eval", "a": 1.5, "b": 2.0}
    assert '[eval] {"iter": 3' in capsys.readouterr().out


@pytest.mark.parametrize("shape, lo", [((13, 8, 6, 3), -1.0), ((5, 7, 7, 1), 0.0), ((64, 32, 32, 3), -1.0)])
def test_png_grid_equals_the_jax_package_pixel_for_pixel(tmp_path, shape, lo):
    """The port writes its PNG with zlib alone; PIL decodes it to the very
    pixels of the JAX package's PIL-written file from the same array."""
    imgs = np.random.default_rng(sum(shape)).uniform(lo, 1.0, shape).astype(np.float32)
    jax_save_image_grid(imgs, str(tmp_path / "jax.png"))
    save_image_grid(imgs, str(tmp_path / "sub" / "port.png"))
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "sub" / "port.png") as b:
        assert a.mode == b.mode == ("L" if shape[-1] == 1 else "RGB")
        assert a.size == b.size
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    raw = (tmp_path / "sub" / "port.png").read_bytes()
    assert raw.startswith(PNG_SIGNATURE)
    with Image.open(io.BytesIO(raw)) as img:
        img.load()  # the CRCs and the zlib stream are valid
    n, h, w, _ = shape
    assert Image.open(io.BytesIO(raw)).size == (8 * (w + 2) + 2, -(-n // 8) * (h + 2) + 2)
