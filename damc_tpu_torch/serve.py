"""Online serving: dynamic micro-batching over the port's samplers.

Counterpart of `damc_tpu/serve.py` for one GPU. Three paths:

  * `damc`  — amortized prior sample: prior embedding of noise, the n-step
              reverse sweep (kernel K2), G decode;
  * `ebm`   — EBM prior sample: the prior-Langevin chain (kernel K1) from
              N(0, I), G decode;
  * `recon` — posterior reconstruction: conv encoder, the sweep (K2), a
              noiseless posterior Langevin through G and E by autograd,
              G decode;

plus a stdlib HTTP front (`make_http_server`) and a CLI
(`damc_tpu_torch.cli.serve`).

Two routes serve each path, as in the JAX package (`fused`,
`damc_tpu/serve.py:250-412`): the fused route above, and the unfused route,
which runs the sweep as the torch loop over the denoiser's step tables
(`ops/reverse_diffusion.py`) and the EBM chain by autograd, launching
neither kernel. Both take the same `RowDraws`, and the unfused route draws
each step's noise from the same per-row counter seeds as the kernels
(`ops/noise.py::counter_normals`), so an item gets the same normals on
either route. `serving_fused_auto` picks the fused route when the kernels'
fit rules take the models, from static facts only; a model they refuse
(an EBM of another layout than 2 hidden layers, a denoiser wider than K2
takes) is served on the unfused route. (JAX's unfused route draws
threefry keys instead: the same contract from another stream.) With `compute_dtype` "bfloat16" G and the
encoder compute in bfloat16 (the images are answered in float32), while K1
keeps float32 products, as the JAX package's serving does.

Per-request determinism, independent of coalescing: item i of a request
with seed s is a pure function of (s, i). The serving path has two layers:

  1. `item_draws(s, i, nz)` derives every random input of the item from
     counter hashes of (s, i) with distinct draw tags (`ops/noise.py`):
     z_init (the sweep's and the EBM chain's start), the prior-embedding
     noise, and a row seed for each kernel's per-row counter noise. Each
     item is drawn on its own, on the CPU. (The JAX package derives these
     from threefry keys instead: the same distribution, another stream.)
  2. `build_serving_fns` gives the batched core over those per-row tensors.
     The kernels compute every row with the same instruction sequence, and
     the entry points pin deterministic cuDNN without TF32
     (`device.resolve_device`); in the default `deterministic=True` mode
     every dispatch pads to `max_batch`, so a row sees the same shapes and
     algorithms whatever it is batched with.

One worker thread per path serializes dispatch; HTTP handler threads only
enqueue and wait on futures.

`SamplerService.from_artifact(dir)` serves the same core from a serving
artifact (`damc_tpu_torch.artifact`): traced programs with the weights
baked in, fed the same stacked draws. That route imports no model or
training module.

Several devices (`mesh`, a `parallel.LocalMesh`; JAX's `SamplerService(
mesh=)`, `damc_tpu/serve.py:427-499`): one process holds a replica of G,
E and Q on each device, splits each padded dispatch into equal row blocks,
runs block i on device i (K1 and K2 launch once a device, on its rows) and
gathers the outputs on the first device (`split_serving_fns`). K1 and K2
compute a row alike at any row count (per-row counter noise), but the
networks around them run at max_batch / n rows, where cuBLAS and cuDNN
may round otherwise than at max_batch: the sweep's tables (the prior
embedding, the encoder), G's decode and the recon path's autograd. So the
answers equal the one-device service's to that rounding, as the sweep
carries it, and are reproducible for one mesh; an item alone still equals
it coalesced. max_batch must divide over the devices; bucketed mode takes
multiples of the device count. A service inside a process group of
several ranks is refused: the service is one controller, as in JAX.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import functools
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .ops.cuda.fused_langevin import fits_ebm
from .ops.cuda.fused_qsweep import denoiser_layer_params
from .ops.diffusion import sweep_schedule
from .ops.langevin import langevin_sample, posterior_energy, prior_langevin_auto
from .ops.noise import counter_bits, counter_normal
from .parallel.distributed import world_size
from .parallel.mesh import LocalMesh

# Draw tags: counter_normal steps 0 and 1 use counters 0..3; the two row
# seeds come from counter 4.
_TAG_Z_INIT, _TAG_EMB_NOISE, _TAG_SEEDS = 0, 1, 4


class RowDraws(NamedTuple):
    """Per-row random inputs of the serving core (leading batch axis)."""

    z_init: torch.Tensor  # (B, nz) float32
    emb_noise: torch.Tensor  # (B, nz) float32
    sweep_seed: torch.Tensor  # (B,) int32: K2's counter seeds
    chain_seed: torch.Tensor  # (B,) int32: K1's counter seeds


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def item_draws(seed: int, index: int, nz: int) -> RowDraws:
    """The random inputs of item `index` of a request with `seed`, as one
    row (batch axis of 1)."""
    key = counter_bits(torch.tensor([int(seed) & 0xFFFFFFFF]), int(index), 1)[:, 0]
    seeds = _as_int32(counter_bits(key, _TAG_SEEDS, 2))
    return RowDraws(
        z_init=counter_normal(key, _TAG_Z_INIT, nz),
        emb_noise=counter_normal(key, _TAG_EMB_NOISE, nz),
        sweep_seed=seeds[:, 0],
        chain_seed=seeds[:, 1],
    )


def stack_draws(rows: Sequence[RowDraws], device) -> RowDraws:
    return RowDraws(*(torch.cat(col).to(device) for col in zip(*rows)))


def serving_fused_auto(models) -> bool:
    """Whether every path of `models` can take the fused route: K2's fit
    rule takes Q's denoiser and, when there is an EBM, K1's takes it
    (`fits_ebm`: the 2-hidden, 1-output layout, at any width).
    JAX's rule (`damc_tpu/serve.py:250-274`) read as the Hopper kernels'
    rules; static facts only, whatever the device (on the CPU the fused
    route runs the kernels' plain versions)."""
    from .models.amortizer import sweep_route

    return sweep_route(models.amortizer) == "k2" and (models.ebm is None or fits_ebm(models.ebm))


def build_serving_fns(models, cfg: Config, recon_langevin_steps: int = 10, fused: bool = True) -> Dict[str, Callable]:
    """The serving core, keyed by path: batched functions of per-row draws
    (and images for `recon`), row i a pure function of row i's inputs.

      'damc'  (draws)    -> images (B, H, W, C)
      'ebm'   (draws)    -> images            (absent without an EBM)
      'recon' (draws, x) -> (x_hat, z)

    `fused` selects the route (module docstring): the kernels K1 and K2,
    which raises for models `serving_fused_auto` refuses, or the unfused
    torch loops. The weights' kernel layouts and Q's step tables are
    computed once, here, on the models' device."""
    from .models.amortizer import sample_q_per_item  # not at import: an artifact service needs no model code

    if fused and not serving_fused_auto(models):
        raise ValueError(
            "fused serving needs models both kernels take: K2's fits_smem for Q's denoiser (at most "
            "256 columns a layer, 227 KB of shared memory a block) and K1's fits_ebm for the EBM "
            "(2 hidden layers, 1 output); serve with fused=False"
        )
    mc = cfg.mcmc
    amort, gen, ebm = models.amortizer, models.generator, models.ebm
    q_kw = dict(fused=fused, step_tables=amort.step_tables(amort.xemb.device))
    if fused:
        q_kw["layers"] = denoiser_layer_params(amort.p)
    else:  # the loop's step scalars, cached before any trace of these functions reads them
        sweep_schedule(amort.n_interval, amort.logsnr_min, amort.logsnr_max, amort.var_type)

    def decode(z):
        # A bfloat16 G (compute_dtype) answers float32 images, the values of
        # its bfloat16 output.
        return gen(z).float().contiguous()

    @torch.no_grad()
    def damc(d: RowDraws) -> torch.Tensor:
        return decode(sample_q_per_item(amort, d.z_init, d.sweep_seed, emb_noise=d.emb_noise, **q_kw))

    @torch.no_grad()
    def recon(d: RowDraws, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z0 = sample_q_per_item(amort, d.z_init, d.sweep_seed, x=x, **q_kw)
        energy = posterior_energy(gen, ebm, x, mc.g_llhd_sigma)
        z, _ = langevin_sample(z0, energy, recon_langevin_steps, mc.g_l_step_size, with_noise=False)
        return decode(z), z

    fns: Dict[str, Callable] = {"damc": damc, "recon": recon}
    if ebm is not None:

        @torch.no_grad()
        def ebm_sample(d: RowDraws) -> torch.Tensor:
            # K1 with float32 products whatever pallas_dots_dtype says: JAX's
            # serving passes no dots_dtype (`damc_tpu/serve.py:360-364`).
            z, _ = prior_langevin_auto(
                d.z_init, ebm, mc.e_l_steps, mc.e_l_step_size, mc.e_l_with_noise,
                row_seeds=d.chain_seed, use_pallas=fused,
            )
            return decode(z)

        fns["ebm"] = ebm_sample
    return fns


def _on(device: torch.device):
    """`device` as the current CUDA device (the kernels launch on the
    current device's stream); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def split_serving_fns(replica_fns: Sequence[Dict[str, Callable]], mesh: LocalMesh) -> Dict[str, Callable]:
    """The serving core over a `LocalMesh`: `replica_fns[i]` is
    `build_serving_fns` of the replica on device i. Each call splits its
    rows into equal blocks (`mesh.blocks`), runs block i on device i and
    concatenates the outputs, in row order, on the first device."""
    first = mesh.devices[0]

    def make(path: str) -> Callable:
        def run(d: RowDraws, *x: torch.Tensor):
            outs = []
            for dev, fns, rows in zip(mesh.devices, replica_fns, mesh.blocks(d.z_init.shape[0])):
                with _on(dev):
                    out = fns[path](RowDraws(*(t[rows].to(dev) for t in d)), *(t[rows].to(dev) for t in x))
                outs.append(out if isinstance(out, tuple) else (out,))
            cols = tuple(torch.cat([o[c].to(first) for o in outs]) for c in range(len(outs[0])))
            return cols if len(cols) > 1 else cols[0]

        return run

    return {path: make(path) for path in replica_fns[0]}


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


@dataclass
class BatchStats:
    """Thread-safe coalescing counters (exposed at GET /stats)."""

    requests: int = 0
    items: int = 0
    batches: int = 0
    padded_items: int = 0
    latency_ms: List[float] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record_batch(self, n_items: int, n_padded: int) -> None:
        with self._lock:
            self.items += n_items
            self.batches += 1
            self.padded_items += n_padded

    def record_request(self, wall_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self.latency_ms.append(wall_ms)
            if len(self.latency_ms) > 4096:  # ring: keep the recent window
                del self.latency_ms[:2048]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.asarray(self.latency_ms, np.float64)
            return {
                "requests": self.requests,
                "items": self.items,
                "batches": self.batches,
                "padded_items": self.padded_items,
                "mean_batch_items": (
                    round(self.items / self.batches, 3) if self.batches else None
                ),
                "latency_p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "latency_p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            }


class _Shutdown:
    pass


class _Future:
    """Single-assignment future on a threading.Event."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request timed out waiting for the batcher")
        if self._exc is not None:
            raise self._exc
        return self._value


class MicroBatcher:
    """Coalesce concurrently submitted items into one device call.

    `run_batch(items) -> results` runs on the worker thread with 1 to
    `max_batch` items: the worker blocks for the first item, then gathers
    until `window_ms` passes or the bucket is full. A failed batch fails
    exactly the futures in that batch; the worker survives."""

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 16,
        window_ms: float = 3.0,
        stats: Optional[BatchStats] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run = run_batch
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.stats = stats or BatchStats()
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="damc-microbatcher", daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> _Future:
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut = _Future()
        self._queue.put((item, fut))
        return fut

    def _gather(self, first) -> Tuple[List[Any], bool]:
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if isinstance(nxt, _Shutdown):
                return batch, True
            batch.append(nxt)
        return batch, False

    def _loop(self) -> None:
        while True:
            nxt = self._queue.get()
            if isinstance(nxt, _Shutdown):
                return
            batch, shutdown = self._gather(nxt)
            items = [it for it, _ in batch]
            try:
                results = self._run(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for {len(items)} items"
                    )
            except Exception as e:  # fail this batch only
                for _, fut in batch:
                    fut.set_exception(e)
            else:
                for (_, fut), res in zip(batch, results):
                    fut.set_result(res)
            if shutdown:
                return

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(_Shutdown())
            self._thread.join(timeout=30)
        # Fail anything that raced past the closed check.
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if not isinstance(nxt, _Shutdown):
                nxt[1].set_exception(RuntimeError("MicroBatcher closed"))


class SamplerService:
    """Micro-batched serving facade over the port's models.

    `device` defaults to CUDA and raises when it is missing; pass
    device='cpu' to serve through the kernels' plain versions. `mesh`, a
    `parallel.LocalMesh`, serves over its devices instead of `device`
    (module docstring); max_batch must divide over them. `fused` picks the
    route (JAX's `fused`, `damc_tpu/serve.py:438-454`): None takes the
    fused route when `serving_fused_auto` holds and the unfused route
    otherwise, True the fused route (a ValueError naming the fit rules
    for models the kernels refuse), False the unfused route; `self.fused`
    says which serves.
    `SamplerService.from_artifact(dir)` builds the same facade over the
    programs of a serving artifact instead of live models."""

    def __init__(
        self,
        models,
        cfg: Config,
        max_batch: int = 16,
        window_ms: float = 3.0,
        recon_langevin_steps: int = 10,
        request_timeout_s: float = 300.0,
        deterministic: bool = True,
        device=None,
        mesh: Optional[LocalMesh] = None,
        fused: Optional[bool] = None,
    ):
        fused = serving_fused_auto(models) if fused is None else bool(fused)
        if mesh is None:
            device = resolve_device(device)
            for m in models.modules():
                m.to(device)
            fns = build_serving_fns(models, cfg, recon_langevin_steps, fused)
        else:
            if world_size() > 1:
                raise ValueError("SamplerService is single-process: one controller serves over the devices "
                                 "of a LocalMesh, not the ranks of a process group")
            if int(max_batch) % mesh.world:
                raise ValueError(f"max_batch={max_batch} must be divisible by the mesh's {mesh.world} devices "
                                 "so every bucket splits evenly")
            replicas = [models] + [copy.deepcopy(models) for _ in mesh.devices[1:]]
            replica_fns = []
            for dev, replica in zip(mesh.devices, replicas):
                resolve_device(dev)
                for m in replica.modules():
                    m.to(dev)
                with _on(dev):
                    replica_fns.append(build_serving_fns(replica, cfg, recon_langevin_steps, fused))
            fns, device = split_serving_fns(replica_fns, mesh), mesh.devices[0]
        self._setup(
            fns, (cfg.model.image_size, cfg.model.image_size, cfg.model.nc),
            cfg.model.nz, max_batch, window_ms, request_timeout_s, deterministic, device, fused, mesh,
        )
        self.cfg = cfg

    @classmethod
    def from_artifact(
        cls, artifact_dir, window_ms: float = 3.0, request_timeout_s: float = 300.0, device=None
    ) -> "SamplerService":
        """Serve from a serving artifact (`damc_tpu_torch.artifact`): its
        loaded programs, with the weights baked in; no model code and no
        checkpoint. An artifact holds one batch size, so the service runs in
        deterministic (single-bucket) mode with max_batch that size."""
        from .artifact import load_serving_artifact

        device = resolve_device(device)
        fns, meta = load_serving_artifact(artifact_dir, device)
        svc = cls.__new__(cls)
        svc._setup(
            fns, tuple(meta["image_shape"]), int(meta["nz"]), int(meta["batch_size"]),
            window_ms, request_timeout_s, True, device, meta["fused"],
        )
        svc.artifact_meta = meta
        return svc

    def _setup(
        self,
        fns: Dict[str, Callable],
        image_shape: Tuple[int, int, int],
        nz: int,
        max_batch: int,
        window_ms: float,
        request_timeout_s: float,
        deterministic: bool,
        device: torch.device,
        fused: bool,
        mesh: Optional[LocalMesh] = None,
    ) -> None:
        self.device = device
        self.fused = fused
        self.mesh = mesh
        self.cfg: Optional[Config] = None
        self.artifact_meta: Optional[Dict[str, Any]] = None
        self.nz = int(nz)
        self.max_batch = int(max_batch)
        self.deterministic = bool(deterministic)
        self.request_timeout_s = float(request_timeout_s)
        self.image_shape = tuple(image_shape)
        self._fns = fns
        self.stats: Dict[str, BatchStats] = {p: BatchStats() for p in fns}
        self._batchers = {
            p: MicroBatcher(
                functools.partial(self._run, p), max_batch=self.max_batch,
                window_ms=window_ms, stats=self.stats[p],
            )
            for p in fns
        }

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(self._fns)

    def _bucket_for(self, n: int) -> int:
        if self.deterministic:
            return self.max_batch
        if self.mesh is None:
            return bucket_size(n, self.max_batch)
        # Bucketed over a mesh: multiples of the device count, so that every
        # dispatch splits evenly (max_batch divides, checked at init).
        k = self.mesh.world
        return min(self.max_batch, -(-n // k) * k)

    def _run(self, path: str, items: List[Tuple]) -> List[Tuple[np.ndarray, ...]]:
        n = len(items)
        padded = items + [items[-1]] * (self._bucket_for(n) - n)
        draws = stack_draws([it[0] for it in padded], self.device)
        if path == "recon":
            x = torch.stack([it[1] for it in padded]).to(self.device)
            out = self._fns[path](draws, x)
        else:
            out = (self._fns[path](draws),)
        host = tuple(o[:n].cpu().numpy() for o in out)
        self.stats[path].record_batch(n, len(padded) - n)
        return [tuple(h[i] for h in host) for i in range(n)]

    def warmup(self) -> None:
        """Run every path once at max_batch: builds and loads the kernels,
        initializes cuDNN, so first requests do not pay for it."""
        x = torch.zeros(self.image_shape)
        items = [(item_draws(0, i, self.nz), x) for i in range(self.max_batch)]
        for path in self._fns:
            self._run(path, items)

    def sample(self, n: int = 1, prior: str = "damc", seed: int = 0) -> np.ndarray:
        """n images (float32 in [-1, 1], NHWC); item i depends only on (seed, i)."""
        if prior not in self._fns or prior == "recon":
            raise ValueError(
                f"unknown prior {prior!r}; available: "
                f"{sorted(p for p in self._fns if p != 'recon')}"
            )
        if not 1 <= n <= 1024:
            raise ValueError(f"n must be in [1, 1024], got {n}")
        t0 = time.monotonic()
        futs = [
            self._batchers[prior].submit((item_draws(seed, i, self.nz),)) for i in range(n)
        ]
        out = np.stack([f.result(self.request_timeout_s)[0] for f in futs])
        self.stats[prior].record_request((time.monotonic() - t0) * 1e3)
        return out

    def reconstruct(self, images: np.ndarray, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior-reconstruct a (B, H, W, C) or (H, W, C) batch in
        [-1, 1]. Returns (x_hat, z), leading axis matching the input."""
        x = np.asarray(images, np.float32)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if x.shape[1:] != self.image_shape:
            raise ValueError(f"expected images shaped (B,)+{self.image_shape}, got {x.shape}")
        t0 = time.monotonic()
        futs = [
            self._batchers["recon"].submit((item_draws(seed, i, self.nz), torch.from_numpy(xi)))
            for i, xi in enumerate(x)
        ]
        results = [f.result(self.request_timeout_s) for f in futs]
        x_hat = np.stack([r[0] for r in results])
        z = np.stack([r[1] for r in results])
        self.stats["recon"].record_request((time.monotonic() - t0) * 1e3)
        return (x_hat[0], z[0]) if squeeze else (x_hat, z)

    def stats_snapshot(self) -> Dict[str, Any]:
        return {p: s.snapshot() for p, s in self.stats.items()}

    def close(self) -> None:
        for b in self._batchers.values():
            b.close()


# --------------------------------------------------------------------------
# HTTP front (stdlib only)
# --------------------------------------------------------------------------


def _encode_array(a: np.ndarray, encoding: str) -> Dict[str, Any]:
    if encoding == "b64":
        return {
            "shape": list(a.shape),
            "dtype": "float32",
            "data_b64": base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode(
                "ascii"
            ),
        }
    return {"shape": list(a.shape), "data": a.tolist()}


def _decode_image(payload: Dict[str, Any]) -> np.ndarray:
    if "image_b64" in payload:
        shape = payload.get("shape")
        if not shape:
            raise ValueError("image_b64 requires a 'shape' field")
        raw = base64.b64decode(payload["image_b64"])
        return np.frombuffer(raw, np.float32).reshape(shape).copy()
    if "image" in payload:
        return np.asarray(payload["image"], np.float32)
    raise ValueError("reconstruct wants 'image' (nested list) or 'image_b64'")


def make_http_server(
    service: SamplerService, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """A threading HTTP server over `service` (port 0 = ephemeral).

    Endpoints:
      GET  /healthz      {"status": "ok", "device", "source", "fused", "paths",
                          "image_shape", "max_batch"}
      GET  /stats        per-path coalescing counters and latency percentiles
      POST /sample       {"n": 4, "prior": "damc"|"ebm", "seed": 0,
                          "encoding": "list"|"b64"}
      POST /reconstruct  {"image": [[...]] | "image_b64"+"shape", "seed": 0,
                          "encoding": "list"|"b64"}
    Call `serve_forever()` on it (e.g. in a thread); `shutdown()`,
    `server_close()` and `service.close()` stop it.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: logs belong to the caller
            pass

        def _reply(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "device": str(service.device),
                        "source": "artifact" if service.artifact_meta else "live",
                        "fused": service.fused,
                        "paths": list(service.paths),
                        "image_shape": list(service.image_shape),
                        "max_batch": service.max_batch,
                    },
                )
            elif self.path == "/stats":
                self._reply(200, service.stats_snapshot())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                encoding = payload.get("encoding", "list")
                if encoding not in ("list", "b64"):
                    raise ValueError(f"unknown encoding {encoding!r}")
                if self.path == "/sample":
                    imgs = service.sample(
                        n=int(payload.get("n", 1)),
                        prior=payload.get("prior", "damc"),
                        seed=int(payload.get("seed", 0)),
                    )
                    self._reply(200, {"images": _encode_array(imgs, encoding)})
                elif self.path == "/reconstruct":
                    x = _decode_image(payload)
                    x_hat, z = service.reconstruct(x, seed=int(payload.get("seed", 0)))
                    self._reply(
                        200,
                        {
                            "x_hat": _encode_array(x_hat, encoding),
                            "z": _encode_array(z, encoding),
                            "mse": float(np.mean((x_hat - x) ** 2)),
                        },
                    )
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # device-side failure: 500, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
