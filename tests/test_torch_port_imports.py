"""Import hygiene of the port: no module under `damc_tpu_torch/` imports JAX,
Flax, Optax, the JAX package, PIL or lmdb (the port depends on no image
library and no LMDB binding: it decodes its PNGs, BMPs, JPEGs and WebPs
itself, `data/images.py`, `data/jpeg.py` and `data/webp.py`, and reads LMDB
through its own C++ reader), and none reads a file under the JAX package's `native/` (it keeps
its own copies under `csrc/host/`). Parsed with `ast`, not read from
`sys.modules`, because the interpreter may import JAX at start-up."""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "damc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "damc_tpu", "PIL", "lmdb")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


FILES = sorted(PORT.rglob("*.py"))


SLICE_4 = (
    "utils/checkpoint.py", "utils/logging.py", "utils/preemption.py", "utils/profiling.py",
    "metrics/fid.py", "models/inception.py", "train/sampling.py", "train/driver_utils.py",
    "data/datasets.py", "cli/common.py", "cli/train_gen_recon.py", "cli/eval_gen_recon.py",
)


SLICE_6 = ("data/images.py", "data/datasets.py", "cli/serve.py")


SLICE_7 = (
    "ops/reverse_diffusion.py", "models/stylegan.py", "train/stylegan_inv.py", "cli/eval_stylegan_inv.py",
    "utils/flops.py",
)


SLICE_9 = (
    "data/_native_build.py", "data/native_loader.py", "data/prefetch.py", "data/jpeg.py", "data/native_lmdb.py",
)


SLICE_10 = ("artifact.py", "cli/convert_checkpoint.py", "cli/export_checkpoint.py")


SLICE_11 = ("parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py")


SLICE_12 = ("parallel/tp.py",)


SLICE_13 = ("data/webp.py",)
SLICE_22 = ("data/gif.py", "data/tiff.py", "data/pnm.py", "data/lzw.py")
SLICE_23 = ("data/fax.py", "data/zstd.py", "data/xz.py", "data/cielab.py", "tools/cielab_clut.py")
SLICE_24 = ("data/formats.py", "data/tga.py", "data/qoi.py", "data/ico.py", "data/icns.py", "data/pcx.py",
            "data/sgi.py", "data/rle.py")


def test_port_has_modules():
    assert len(FILES) >= 50
    assert set(SLICE_4 + SLICE_6 + SLICE_7 + SLICE_9 + SLICE_10 + SLICE_11 + SLICE_12 + SLICE_13 + SLICE_22
               + SLICE_23 + SLICE_24) <= {str(p.relative_to(PORT)) for p in FILES}
    assert {p.name for p in (PORT / "csrc" / "host").glob("*.cpp")} == {
        "batch_loader.cpp", "fax_decode.cpp", "jpeg_decode.cpp", "lmdb_reader.cpp", "lzw_decode.cpp",
        "rle_decode.cpp", "webp_decode.cpp", "zstd_decode.cpp"}


def _code_strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PORT)))
def test_no_read_of_the_jax_native_sources(path):
    """The port builds its host libraries from its own `csrc/host/`: no
    string in its code names the JAX package's `native/` directory."""
    bad = [v for v in _code_strings(ast.parse(path.read_text(), str(path))) if v == "native" or "native/" in v]
    assert not bad, f"{path} names {bad}"


def test_host_build_reads_csrc_host():
    from damc_tpu_torch.data import _native_build

    assert _native_build.SRC_DIR == PORT / "csrc" / "host"
    assert all((_native_build.SRC_DIR / f"{name}.cpp").is_file() for name in _native_build.LIBRARIES)


MODULES = [
    ".".join(["damc_tpu_torch", *p.relative_to(PORT).with_suffix("").parts]).removesuffix(".__init__")
    for p in FILES
]


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_without_a_card(name):
    """Every module imports here, with no nvcc, no triton and no card: the
    kernels are built and loaded only when first launched."""
    importlib.import_module(name)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_import(path):
    bad = [
        name for name in _imports(ast.parse(path.read_text(), str(path)))
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("rel", SLICE_11)
def test_the_process_group_layer_is_torch_distributed(rel):
    """parallel/ is the port's counterpart of the JAX package's
    `parallel/`: built on torch.distributed, with nothing of JAX (the test
    above holds every module to that)."""
    names = set(_imports(ast.parse((PORT / rel).read_text())))
    assert rel.endswith("__init__.py") or "torch.distributed" in names or "torch" in names


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of JAX or the JAX package; it may
    import PIL (and only it of the port's forbidden names), as the oracle
    that the port's image decoders are held against on the card."""
    path = PORT.parent / "chip_smoke.py"
    bad = [n for n in _imports(ast.parse(path.read_text())) if n.split(".")[0] in FORBIDDEN and n != "PIL"]
    assert not bad
