"""A group of gloo ranks on the CPU for the port's data-parallel tests, and
the functions its ranks run.

`GlooGroup(world)` starts `world` Python processes with torchrun's
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`; the port from binding port 0). Each joins the group through
the port's own `parallel.distributed.initialize_distributed(backend="gloo",
device="cpu")` and then serves tasks: `group.run(fn, *args)` sends the
module-level function `fn` (by name) and its pickled arguments to every
rank and returns the ranks' results in rank order. One group serves a
whole test module, so the processes start once (about 3 s).

Nothing hangs for long: every collective times out after `COLLECTIVE_S`,
every `run` after its `timeout` (120 s at most). A rank whose task raises
sends its traceback, leaves the group (so that its peers' collectives fail
at once instead of waiting) and exits; `run` then raises with every rank's
traceback and the tail of its log, and the group is closed. `closed`
tells a fixture to start a new one.

This module imports no JAX: the ranks import it, and only torch and the
port.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import pickle
import secrets
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import Client, Listener, wait

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_S = 60  # a rank's collectives and its rendezvous give up after this
RUN_S = 120  # most a task may take


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _send(conn, obj) -> None:
    # Plain pickle: a Connection's own pickler would pass torch tensors
    # through shared memory, which only processes of one family can open.
    conn.send_bytes(pickle.dumps(obj))


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


class GlooGroup:
    """`world` gloo ranks on the CPU serving tasks (module docstring)."""

    def __init__(self, world: int, timeout: float = RUN_S):
        self.world = world
        self.closed = False
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        self._logs = [tempfile.NamedTemporaryFile("w+", prefix=f"gloo_rank{r}_", suffix=".log") for r in range(world)]
        port = free_port()
        path = os.pathsep.join([REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")])
        self._procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=path,
                       OMP_NUM_THREADS="1")
            self._procs.append(subprocess.Popen(
                [sys.executable, "-c", "import torch_port_gloo as g, sys; g.serve(sys.argv[1], sys.argv[2])",
                 f"{self._listener.address[0]}:{self._listener.address[1]}", key.hex()],
                env=env, stdout=self._logs[r], stderr=subprocess.STDOUT, cwd=REPO,
            ))
        self._conns = [None] * world
        self._listener._listener._socket.settimeout(timeout)
        try:
            conns = [self._listener.accept() for _ in range(world)]  # each rank's handshake needs its accept
            deadline = time.monotonic() + timeout
            while conns:  # a rank reports its number once the group has formed
                ready = wait(conns, timeout=max(deadline - time.monotonic(), 0))
                if not ready:
                    raise TimeoutError("the ranks connected but did not form the group")
                for conn in ready:
                    conns.remove(conn)
                    self._conns[_recv(conn)] = conn
        except BaseException as e:
            self._fail(f"the group of {world} did not start: {e!r}")

    def run(self, fn, *args, timeout: float = RUN_S):
        """fn(*args) on every rank; the results in rank order."""
        if self.closed:
            raise RuntimeError("the group is closed")
        timeout = min(timeout, RUN_S)
        for c in self._conns:
            _send(c, (fn.__module__, fn.__qualname__, args))
        results, errors = [None] * self.world, {}
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + timeout
        while pending:
            ready = wait(list(pending.values()), timeout=max(deadline - time.monotonic(), 0))
            if not ready:
                self._fail(f"{fn.__qualname__} did not finish on ranks {sorted(pending)} in {timeout} s",
                           errors)
            for conn in ready:
                r = next(k for k, c in pending.items() if c is conn)
                del pending[r]
                try:
                    status, value = _recv(conn)
                except EOFError:
                    status, value = "err", "the rank exited"
                if status == "ok":
                    results[r] = value
                else:
                    errors[r] = value
        if errors:
            self._fail(f"{fn.__qualname__} failed", errors)
        return results

    def _log(self, r: int) -> str:
        self._logs[r].flush()
        self._logs[r].seek(0)
        return self._logs[r].read()[-4000:]

    def _fail(self, what: str, errors=None):
        self._stop()
        detail = "".join(
            f"\n--- rank {r} ---\n{(errors or {}).get(r, '')}\nlog:\n{self._log(r)}" for r in range(self.world)
        )
        self.close()
        raise AssertionError(what + detail)

    def close(self) -> None:
        """Stop every rank (asked first, killed after 10 s)."""
        if self._listener is None:
            return
        self._stop()
        self._listener.close()
        self._listener = None
        for f in self._logs:
            f.close()

    def _stop(self) -> None:
        self.closed = True
        for c in self._conns:
            if c is not None:
                with contextlib.suppress(OSError):
                    _send(c, None)
        for p in self._procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def groups():
    """Generator for a module-scoped fixture: get(world) -> a live group of
    that size, started on first use and again after a failure; all closed
    at the end."""
    live = {}

    def get(world: int) -> GlooGroup:
        if world not in live or live[world].closed:
            live[world] = GlooGroup(world)
        return live[world]

    try:
        yield get
    finally:
        for g in live.values():
            g.close()


def serve(address: str, key_hex: str) -> None:
    """A rank's main loop: join the group, then run tasks until told to stop
    or until one raises."""
    import torch

    from damc_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed

    torch.set_num_threads(1)
    host, port = address.rsplit(":", 1)
    conn = Client((host, int(port)), authkey=bytes.fromhex(key_hex))
    initialize_distributed(backend="gloo", device="cpu", timeout_s=COLLECTIVE_S)
    _send(conn, int(os.environ["RANK"]))
    try:
        while True:
            task = _recv(conn)
            if task is None:
                return
            module, name, args = task
            try:
                _send(conn, ("ok", getattr(importlib.import_module(module), name)(*args)))
            except BaseException:
                _send(conn, ("err", traceback.format_exc()))
                return
    finally:
        shutdown_distributed()


# --- the ranks' tasks ------------------------------------------------------


def _mesh():
    from damc_tpu_torch.parallel.distributed import global_mesh

    return global_mesh("cpu")


def _tensors(obj):
    """numpy arrays (also inside lists and tuples) -> torch tensors."""
    import torch

    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors(o) for o in obj)
    return obj


def sharded_kernel(kernel: str, args, kwargs):
    """K4a ("K1") or K4b ("K2") on the global batch `args` (numpy), every
    rank the same; returns the gathered result and the plain-version
    launches this rank made (rows, row_base) through the custom ops."""
    from damc_tpu_torch.ops.cuda import fused_langevin, fused_qsweep

    mesh = _mesh()
    calls = []
    module, plain = (fused_langevin, "prior_langevin_plain") if kernel == "K1" else (fused_qsweep, "reverse_sweep_plain")
    original = getattr(module, plain)

    def counting(z, *a, **kw):
        calls.append((int(z.shape[0]), int(kw.get("row_base", 0))))
        return original(z, *a, **kw)

    setattr(module, plain, counting)
    try:
        if kernel == "K1":
            out = fused_langevin.fused_prior_langevin_sharded(mesh, *_tensors(args), **_tensors(kwargs))
        else:
            out = fused_qsweep.fused_reverse_sweep_sharded(mesh, *_tensors(args), **_tensors(kwargs))
    finally:
        setattr(module, plain, original)
    return out.numpy(), calls


def global_batch(x_global):
    """`make_global_batch` of this rank's rows of x_global (numpy)."""
    from damc_tpu_torch.parallel import shard_batch
    from damc_tpu_torch.parallel.distributed import make_global_batch

    mesh = _mesh()
    return make_global_batch(mesh, shard_batch(mesh, x_global)).numpy()


def state_arrays(state) -> dict:
    """Every network tensor of a TrainState, by '<net>.<key>', as numpy."""
    m = state.models
    nets = {"G": m.generator, "E": m.ebm, "Q": m.amortizer, "Q_ema": state.amortizer_ema}
    return {f"{n}.{k}": v.detach().numpy().copy() for n, mod in nets.items() if mod is not None
            for k, v in mod.state_dict().items()}


def train_steps(cfg, ckpt_dir: str, xs, draws):
    """The port's data-parallel train step from the checkpoint
    `ckpt_dir`/0, once per global batch in `xs` (numpy) with the global
    `draws` of each; returns (metrics of each step as floats, the state's
    tensors)."""
    import torch

    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import make_train_step
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint
    from damc_tpu_torch.parallel import shard_batch

    mesh = _mesh()
    state = restore_checkpoint(ckpt_dir, "0", create_state(cfg, 0, "cpu"))
    step = make_train_step(state.models, state.opts, cfg, mesh=mesh)
    metrics = []
    for x, d in zip(xs, draws):
        state, m = step(state, shard_batch(mesh, torch.from_numpy(x)), d)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_arrays(state)


def sharded_stats(batches, fold_every: int):
    """`compute_stats_sharded` of the global batches (numpy (n, dim)), each
    rank feeding its rows, with the identity as the feature map."""
    import torch

    from damc_tpu_torch.metrics.fid import compute_stats_sharded
    from damc_tpu_torch.parallel import shard_batch

    mesh = _mesh()
    rows = (shard_batch(mesh, torch.from_numpy(b)) for b in batches)
    return compute_stats_sharded(lambda t: t, rows, dim=batches[0].shape[1], fold_every=fold_every)


def train_cli(argv):
    """`cli.train_gen_recon.main(argv)` on every rank; returns (the
    checkpoint names and grid files this rank saved, its metrics rows
    written, the final state's tensors)."""
    from damc_tpu_torch.cli import train_gen_recon
    from damc_tpu_torch.train import driver_utils, gen_recon
    from damc_tpu_torch.utils import logging as port_logging

    saves, grids, rows = [], [], []
    patches = [
        (driver_utils, "save_checkpoint", lambda d, name, s, f=driver_utils.save_checkpoint: (saves.append(name), f(d, name, s))[1]),
        (gen_recon, "save_image_grid", lambda a, path, f=gen_recon.save_image_grid, **kw: (grids.append(os.path.basename(path)), f(a, path, **kw))[1]),
        (port_logging.MetricsLogger, "log", lambda self, *a, f=port_logging.MetricsLogger.log, **kw: (rows.append(self.path), f(self, *a, **kw))[1]),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        state = train_gen_recon.main(argv)
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    return saves, grids, [p for p in rows if p is not None], int(state.step), state_arrays(state)


def eval_cli(argv):
    """`cli.eval_gen_recon.main(argv)`; returns (its numbers, what it printed)."""
    from damc_tpu_torch.cli import eval_gen_recon

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        numbers = eval_gen_recon.main(argv)
    return numbers, out.getvalue()


def preempted_loop(iterations: int, signal_rank: int, signal_at: int):
    """`driver_utils.run_loop` over `iterations` with no checkpoints or
    evals, rank `signal_rank` sending itself SIGTERM during iteration
    `signal_at`; returns (the iterations run, whether it was stopped)."""
    import types

    from damc_tpu_torch.train.driver_utils import run_loop

    mesh = _mesh()
    ran = []

    def iterate(it):
        ran.append(it)
        if mesh.rank == signal_rank and it == signal_at:
            os.kill(os.getpid(), signal.SIGTERM)

    tc = types.SimpleNamespace(ckpt_every=0, eval_every=0)
    stopped = run_loop(tc, None, 0, iterations, None, iterate, None, mesh)
    return ran, stopped


# --- the tasks of the anomaly, inversion, serving and channel-parallel tests


def _counting_plain(calls):
    """Patch the plain versions behind K1 and K2 to record each call's
    (kernel, rows, row_base); returns the undo function."""
    from damc_tpu_torch.ops.cuda import fused_langevin, fused_qsweep

    patched = []
    for module, name, kernel in ((fused_langevin, "prior_langevin_plain", "K1"),
                                 (fused_qsweep, "reverse_sweep_plain", "K2")):
        original = getattr(module, name)

        def counting(z, *a, _original=original, _kernel=kernel, **kw):
            calls.append((_kernel, int(z.shape[0]), int(kw.get("row_base", 0))))
            return _original(z, *a, **kw)

        setattr(module, name, counting)
        patched.append((module, name, original))
    return lambda: [setattr(m, n, o) for m, n, o in patched]


def counted_train_steps(cfg, ckpt_dir: str, xs, draws):
    """`train_steps`, with the (kernel, rows, row_base) of every K1 and K2
    call of the steps appended to its result."""
    calls = []
    undo = _counting_plain(calls)
    try:
        metrics, arrays = train_steps(cfg, ckpt_dir, xs, draws)
    finally:
        undo()
    return metrics, arrays, calls


def auprc_eval(cfg, ckpt_dir: str, images, labels, batch: int, steps: int, seed: int):
    """`evaluate_auprc(..., mesh=)` of the checkpoint `ckpt_dir`/0 on this
    rank; returns (the AUPRC, the scores it was taken over, the K2 calls)."""
    from damc_tpu_torch.train import anomaly
    from damc_tpu_torch.train.gen_recon import make_draws_fn
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint

    mesh = _mesh()
    state = restore_checkpoint(ckpt_dir, "0", create_state(cfg, 0, "cpu"))
    seen, calls = [], []
    original = anomaly.auprc
    anomaly.auprc = lambda s, y: (seen.append(np.array(s)), original(s, y))[1]
    undo = _counting_plain(calls)
    try:
        score = anomaly.evaluate_auprc(state.models, cfg, images, labels,
                                       make_draws_fn(seed, "auprc", 0, cfg.model.nz, "cpu"),
                                       batch=batch, langevin_steps=steps, mesh=mesh)
    finally:
        anomaly.auprc = original
        undo()
    return score, seen[0], calls


def anomaly_cli(which: str, argv):
    """`cli.train_anomaly_det.main(argv)` ("train": returns the checkpoint
    names this rank saved, its metrics rows written, the step, the state's
    tensors, the best AUPRC) or `cli.eval_anomaly_det.main(argv)` ("eval":
    returns the AUPRC and what it printed)."""
    from damc_tpu_torch.cli import eval_anomaly_det, train_anomaly_det
    from damc_tpu_torch.train import driver_utils
    from damc_tpu_torch.utils import logging as port_logging

    if which == "eval":
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            score = eval_anomaly_det.main(argv)
        return score, out.getvalue()
    saves, rows = [], []
    patches = [
        (driver_utils, "save_checkpoint", lambda d, name, s, f=driver_utils.save_checkpoint: (saves.append(name), f(d, name, s))[1]),
        (port_logging.MetricsLogger, "log", lambda self, *a, f=port_logging.MetricsLogger.log, **kw: (rows.append(self.path), f(self, *a, **kw))[1]),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        state, best = train_anomaly_det.main(argv)
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    return saves, [p for p in rows if p is not None], int(state.step), state_arrays(state), best


def inversion_eval(res: int, seed: int, images, batch: int, steps: int, fourier_damp: float, world_one: bool = False):
    """`evaluate_inversion` of seeded random StyleGAN networks and Q at
    resolution `res` (Q's Fourier matrix times `fourier_damp`) over
    `images` with the random feature map, on this rank's rows (or, with
    `world_one`, the whole batches on this rank alone); returns its numbers
    and whether a batch of batch + 1 raised."""
    import dataclasses

    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.metrics.fid import make_random_feature_fn
    from damc_tpu_torch.models.stylegan import build_stylegan
    from damc_tpu_torch.train import stylegan_inv as inv

    mesh = None if world_one else _mesh()
    cfg = preset("celebaHQ")
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, n_interval=2))
    nets = build_stylegan(res, seed=seed, device="cpu")
    q = inv.make_stylegan_amortizer(cfg, res, seed=seed, device="cpu")
    with torch.no_grad():
        q.p.B.mul_(fourier_damp)
    kw = dict(steps=steps, lr=0.05, seed=3, feature_fn=make_random_feature_fn((res, res, 3)),
              real_mu=np.zeros(192), real_sigma=np.eye(192), fid_metric_name="frechet_rand", mesh=mesh)
    out = inv.evaluate_inversion(q, nets, images, batch=batch, **kw)
    try:
        inv.evaluate_inversion(q, nets, images[:1], batch=batch + 1, **kw)
        raised = False
    except ValueError as e:
        raised = "must divide" in str(e)
    return out, raised


def serve_in_group():
    """A `SamplerService` over `LocalMesh(["cpu", "cpu"])` inside this
    group of processes; returns the error it raises."""
    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.parallel import LocalMesh
    from damc_tpu_torch.serve import SamplerService
    from torch_port_helpers import tiny

    cfg = tiny(preset("svhn"))
    try:
        SamplerService(build_models(cfg, seed=1, device="cpu"), cfg, max_batch=4, mesh=LocalMesh(["cpu", "cpu"]))
    except ValueError as e:
        return str(e)
    return None


def tp_synthesis(res: int, seed: int, wp, min_channels: int):
    """The synthesis of a seeded random StyleGAN generator at resolution
    `res` with its wide parameters channel-sharded over the group
    (`shard_params_channelwise`): returns (the sharding tree, the image of
    `wp` (numpy), the gradient of the image's sum of squares with respect
    to wp and to each parameter (None where it takes none), the sharded
    ones gathered, by name, and the number of elements this rank holds)."""
    import torch
    from torch.nn.utils import parametrize

    from damc_tpu_torch.models.stylegan import build_stylegan
    from damc_tpu_torch.parallel import channel_sharding_tree, gather_rows, shard_params_channelwise

    mesh = _mesh()
    gen = build_stylegan(res, seed=seed, device="cpu").generator.requires_grad_(True)
    tree = channel_sharding_tree(mesh, gen, min_channels)
    shard_params_channelwise(mesh, gen, min_channels)
    x = torch.from_numpy(wp).requires_grad_(True)
    img = gen(x)
    (img**2).sum().backward()
    grads = {}
    for name, dim in tree.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = gen.get_submodule(owner_name)
        local = getattr(owner, leaf).grad if dim is None else owner.parametrizations[leaf].original.grad
        if local is None:  # a parameter the synthesis does not read (the mapping network's)
            grads[name] = None
        elif dim is None:
            grads[name] = local.numpy()
        else:
            grads[name] = gather_rows(mesh, local.movedim(dim, 0).contiguous()).movedim(0, dim).numpy()
        assert parametrize.is_parametrized(owner, leaf) == (dim is not None)
    held = sum(p.numel() for p in gen.parameters())
    return tree, img.detach().numpy(), x.grad.numpy(), grads, held


def drawn_train_steps(cfg, ckpt_dir: str, xs):
    """The port's data-parallel train step from the checkpoint
    `ckpt_dir`/0 over the global batches `xs` (numpy), each step's draws
    made as a run makes them: `draw_step` for the global batch from this
    rank's own generator. Returns (metrics of each step as floats, the
    state's tensors, each step's chain_noise as numpy or None, the
    (kernel, rows, row_base) of every K1 and K2 call)."""
    import torch

    from damc_tpu_torch.parallel import shard_batch
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import draw_step, make_train_step
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint

    mesh = _mesh()
    state = restore_checkpoint(ckpt_dir, "0", create_state(cfg, 0, "cpu"))
    step = make_train_step(state.models, state.opts, cfg, mesh=mesh)
    metrics, noises, calls = [], [], []
    undo = _counting_plain(calls)
    try:
        for x in xs:
            d = draw_step(cfg, len(x), state)
            noises.append(None if d.chain_noise is None else d.chain_noise.numpy().copy())
            state, m = step(state, shard_batch(mesh, torch.from_numpy(x)), d)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        undo()
    return metrics, state_arrays(state), noises, calls
