"""Full-state checkpoints of the port (`damc_tpu_torch/utils/checkpoint.py`)
on the CPU: every tensor, each optimizer's state and update count, the
device generator, the step and the seed come back exactly, and the next
training step from a restored state equals, bit for bit, the step from the
state that was saved (`tests/test_checkpoint.py` holds the JAX package to
the same)."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import make_train_step
from damc_tpu_torch.utils.checkpoint import FILE, latest_step, restore_checkpoint, save_checkpoint
from torch_port_helpers import tiny, to_numpy, train_cfgs
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


def tiny_cfg():
    cfg = tiny(preset("svhn"))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=4, q_updates=2))


def _x(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))


def _trained(cfg, seed=0, steps=2):
    state = create_state(cfg, seed=seed, device="cpu")
    step = make_train_step(state.models, state.opts, cfg)
    for i in range(steps):
        state, _ = step(state, _x(i))
    return state


def _modules(state):
    m = state.models
    return {"G": m.generator, "E": m.ebm, "Q": m.amortizer, "Q_ema": state.amortizer_ema}


def assert_states_equal(a, b):
    assert (a.step, a.seed) == (b.step, b.seed)
    for name, ma in _modules(a).items():
        sa, sb = ma.state_dict(), _modules(b)[name].state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    for oa, ob in zip((a.opts.g, a.opts.e, a.opts.q), (b.opts.g, b.opts.e, b.opts.q)):
        assert oa.count == ob.count
        da, db = oa.opt.state_dict(), ob.opt.state_dict()
        assert da["param_groups"] == db["param_groups"]
        assert da["state"].keys() == db["state"].keys() and len(da["state"]) == len(oa.params)
        for i, st in da["state"].items():
            for k, v in st.items():
                assert torch.equal(v, db["state"][i][k]), (i, k)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_full_state_round_trip(tmp_path):
    cfg = tiny_cfg()
    state = _trained(cfg, seed=3)
    assert state.step == 2 and state.opts.q.count == 4
    path = save_checkpoint(str(tmp_path), "2", state)
    assert path == os.path.join(str(tmp_path), "2") and os.path.exists(os.path.join(path, FILE))
    restored = restore_checkpoint(str(tmp_path), "2", create_state(cfg, seed=99, device="cpu"))
    assert_states_equal(restored, state)
    # Nothing is left in staging.
    assert sorted(os.listdir(tmp_path)) == ["2"]


def test_step_after_restore_equals_step_before_save(tmp_path):
    """step(restore(save(s)), x) == step(s, x), bit for bit: metrics, every
    tensor of the state and the generator after the step."""
    cfg = tiny_cfg()
    state = _trained(cfg, seed=5)
    save_checkpoint(str(tmp_path), "best", state)
    restored = restore_checkpoint(str(tmp_path), "best", create_state(cfg, seed=0, device="cpu"))
    x = _x(7)
    s_a, m_a = make_train_step(state.models, state.opts, cfg)(state, x)
    s_b, m_b = make_train_step(restored.models, restored.opts, cfg)(restored, x)
    assert m_a.keys() == m_b.keys()
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    assert_states_equal(s_a, s_b)


def test_save_over_an_existing_checkpoint_replaces_it(tmp_path):
    cfg = tiny_cfg()
    first, second = _trained(cfg, seed=1, steps=1), _trained(cfg, seed=2, steps=2)
    save_checkpoint(str(tmp_path), "best", first)
    save_checkpoint(str(tmp_path), "best", second)
    assert sorted(os.listdir(tmp_path)) == ["best"]
    assert_states_equal(restore_checkpoint(str(tmp_path), "best", create_state(cfg, device="cpu")), second)


def test_latest_step_ignores_best_and_staging(tmp_path):
    assert latest_step(str(tmp_path / "absent")) is None
    assert latest_step(str(tmp_path)) is None
    for d in ("100", "2500", "best", "3000.tmp-abc123", "best.old-x", "99x"):
        (tmp_path / d).mkdir()
    assert latest_step(str(tmp_path)) == 2500


def test_state_carried_from_jax_survives_save_and_restore(tmp_path):
    cfg_j, cfg_p = train_cfgs("svhn")
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(2), cfg_j)
    x = np.random.default_rng(3).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    state, _ = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j))(state, jnp.asarray(x))
    port = train_state_from_jax(to_numpy(state), cfg_p, seed=4, device="cpu")
    save_checkpoint(str(tmp_path), "1", port)
    restored = restore_checkpoint(str(tmp_path), "1", create_state(cfg_p, seed=0, device="cpu"))
    assert restored.step == 1 and restored.opts.q.count == cfg_p.train.q_updates
    assert_states_equal(restored, port)
