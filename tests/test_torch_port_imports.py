"""Import hygiene of the port: no module under `damc_tpu_torch/` imports JAX,
Flax, Optax, the JAX package or PIL (the port depends on no image
library: it decodes its PNGs itself, `data/images.py`). Parsed with `ast`, not
read from `sys.modules`, because the interpreter may import JAX at
start-up."""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "damc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "damc_tpu", "PIL")


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


def test_port_has_modules():
    assert len(FILES) >= 45
    assert set(SLICE_4 + SLICE_6 + SLICE_7) <= {str(p.relative_to(PORT)) for p in FILES}


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


def test_chip_smoke_imports_no_jax():
    path = PORT.parent / "chip_smoke.py"
    bad = [n for n in _imports(ast.parse(path.read_text())) if n.split(".")[0] in FORBIDDEN]
    assert not bad
