"""ctypes binding of the read-only LMDB reader (counterpart of
`damc_tpu/data/native_lmdb.py`): `csrc/host/lmdb_reader.cpp`, a copy of the
JAX package's `native/lmdb_reader.cpp`, memory-maps `data.mdb`, picks the
newer valid meta page and walks the main database's B+tree for point reads
and ordered key scans, with no liblmdb. `NativeLMDBEnv` serves the surface
the LSUN readers use:

    with env.begin() as txn:
        txn.stat()["entries"]
        txn.get(key)                                  -> bytes | None
        txn.cursor().iternext(keys=True, values=False) -> iter of key bytes

Writes, dupsort databases and LEAF2 pages are out of scope (LSUN databases
use none). The port always reads through this reader; the library is built
on first use and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional

import numpy as np

from . import _native_build


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_lmdb_open.restype = ctypes.c_void_p
    lib.damc_lmdb_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.damc_lmdb_entries.restype = ctypes.c_uint64
    lib.damc_lmdb_entries.argtypes = [ctypes.c_void_p]
    lib.damc_lmdb_get.restype = ctypes.c_int
    lib.damc_lmdb_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.damc_lmdb_keys_size.restype = ctypes.c_int64
    lib.damc_lmdb_keys_size.argtypes = [ctypes.c_void_p]
    lib.damc_lmdb_keys_fill.restype = ctypes.c_int64
    lib.damc_lmdb_keys_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.damc_lmdb_error.restype = None
    lib.damc_lmdb_error.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
    ]
    lib.damc_lmdb_close.restype = None
    lib.damc_lmdb_close.argtypes = [ctypes.c_void_p]


class _Cursor:
    def __init__(self, keys: List[bytes]):
        self._keys = keys

    def iternext(self, keys: bool = True, values: bool = True) -> Iterator:
        if keys and not values:
            return iter(self._keys)
        raise NotImplementedError(
            "native LMDB cursor supports keys-only iteration "
            "(iternext(keys=True, values=False))"
        )


class _Txn:
    """Read snapshot view (the whole env is one read-only snapshot)."""

    def __init__(self, env: "NativeLMDBEnv"):
        self._env = env

    def stat(self) -> dict:
        return {"entries": self._env._entries}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._env._get(key)

    def cursor(self) -> _Cursor:
        return _Cursor(self._env._keys())

    def __enter__(self) -> "_Txn":
        return self

    def __exit__(self, *exc) -> None:
        pass


class NativeLMDBEnv:
    """Read-only LMDB environment backed by the native parser.

    `path` is the database directory (containing data.mdb) or the data.mdb
    file itself (MDB_NOSUBDIR layout).
    """

    def __init__(self, path: str):
        lib = _native_build.load("lmdb_reader", _configure)
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._h = lib.damc_lmdb_open(os.fsencode(path), err, len(err))
        if not self._h:
            raise OSError(f"cannot open LMDB env at {path}: {err.value.decode()}")
        self._entries = int(lib.damc_lmdb_entries(self._h))
        self._key_cache: Optional[List[bytes]] = None

    def begin(self, write: bool = False) -> _Txn:
        if write:
            raise NotImplementedError("native LMDB env is read-only")
        if self._h is None:
            raise RuntimeError("env is closed")
        return _Txn(self)

    def _last_error(self) -> str:
        # Copies the error under the native lock (the raw c_str() pointer
        # raced concurrent error writes from other reader threads).
        buf = ctypes.create_string_buffer(512)
        self._lib.damc_lmdb_error(self._h, buf, len(buf))
        return buf.value.decode(errors="replace")

    def _get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_uint64()
        rc = self._lib.damc_lmdb_get(
            self._h, bytes(key), len(key), ctypes.byref(val), ctypes.byref(vlen)
        )
        if rc < 0:
            raise OSError(
                f"LMDB read error: {self._last_error()}"
            )
        if rc == 0:
            return None
        return ctypes.string_at(val.value, vlen.value)

    def _keys(self) -> List[bytes]:
        if self._key_cache is None:
            total = self._lib.damc_lmdb_keys_size(self._h)
            if total < 0:
                raise OSError(
                    f"LMDB key scan error: {self._last_error()}"
                )
            blob = np.empty(max(int(total), 1), np.uint8)
            lens = np.empty(max(self._entries, 1), np.uint32)
            n = self._lib.damc_lmdb_keys_fill(
                self._h, blob.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p),
            )
            if n < 0:
                raise OSError(
                    f"LMDB key scan error: {self._last_error()}"
                )
            raw = blob.tobytes()
            out, off = [], 0
            for ln in lens[: int(n)]:
                out.append(raw[off : off + int(ln)])
                off += int(ln)
            self._key_cache = out
        return self._key_cache

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.damc_lmdb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
