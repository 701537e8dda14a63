"""Build the host C++ libraries with g++ and load them with ctypes
(counterpart of `damc_tpu/data/_native_build.py`, on the pattern of
`ops/cuda/build.py`).

Each `damc_tpu_torch/csrc/host/<name>.cpp` becomes its own shared library
with a plain C interface:

    g++ -O3 -std=c++17 -shared -fPIC -pthread \
        -o build/damc_tpu_torch/<name>-<hash>.so csrc/host/<name>.cpp

The file name carries a hash of the source, the flags and the compiler's
version, so an edited source or a new compiler is rebuilt and an unchanged
one is not. Libraries go to `build/damc_tpu_torch/` at the repo root, which
git ignores. `build()` starts one compiler per source, all at once;
`load()` builds on first use. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "damc_tpu_torch"
LIBRARIES = ("batch_loader", "fax_decode", "jpeg_decode", "lmdb_reader", "lzw_decode", "rle_decode", "webp_decode",
             "zstd_decode")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_compiler: Optional[tuple] = None


def compiler() -> tuple:
    """(path, version) of the host C++ compiler: g++, else c++."""
    global _compiler
    if _compiler is None:
        path = shutil.which("g++") or shutil.which("c++")
        if path is None:
            raise RuntimeError("no C++ compiler (g++ or c++) found: the host libraries cannot be built")
        version = subprocess.run([path, "-dumpfullversion", "-dumpversion"], capture_output=True, text=True,
                                 timeout=60).stdout.strip()
        _compiler = (path, version)
    return _compiler


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(compiler()[1].encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = LIBRARIES) -> Dict[str, Dict[str, object]]:
    """Compile every named source that has no library yet, one compiler
    each, all started together. Returns {name: {path, seconds, log}};
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = compiler()[0]
    procs = {}
    out: Dict[str, Dict[str, object]] = {}
    t0 = time.monotonic()
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": "cached"}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [cxx, *FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: another process never loads half a file
        out[name] = {"path": str(path), "seconds": time.monotonic() - t0, "log": log}
    if failed:
        raise RuntimeError("the host C++ build failed for " + "\n".join(failed))
    return out


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The named host library, built on first use, loaded once, with
    `configure(lib)` (its argtypes and restypes) applied on load."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            configure(lib)
            _loaded[name] = lib
        return lib
