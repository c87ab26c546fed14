"""ctypes bridge to the native SBLK block codec (sharp_tpu/native/blockio.cpp).

Builds the shared library on first use with the system g++ (cached under
`<checkout>/.cache/native`, rebuilt when the source changes); falls back
to `None` when no toolchain is available — callers must keep a
pure-numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "native", "blockio.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

MAGIC = b"SBLK1\0\0\0"


def _build_lib() -> Optional[ctypes.CDLL]:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    from sharp_tpu.utils.cache import local_cache_dir

    cache = local_cache_dir("native")
    so = os.path.join(cache, f"blockio_{tag}.so")
    if not os.path.exists(so):
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-pthread",
            "-std=c++17", src, "-o", so + ".tmp",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(so + ".tmp", so)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.sblk_read_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.sblk_read_header.restype = ctypes.c_int
    lib.sblk_densify.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.sblk_densify.restype = ctypes.c_int
    lib.sblk_densify_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.sblk_densify_rows.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_lib()
            _TRIED = True
        return _LIB


def write_sblk(path: str, X, dtype_code: Optional[int] = None) -> None:
    """Write a cells-by-genes matrix (dense ndarray or scipy CSR) as SBLK.

    dtype_code: 0 stores f32 values, 1 stores u16 (lossless only for
    integer counts < 65536); auto-picks u16 when values are such counts.
    """
    import scipy.sparse as sp

    if sp.issparse(X):
        csr = X.tocsr()
    else:
        csr = sp.csr_matrix(np.asarray(X))
    csr.sum_duplicates()
    data = csr.data
    if dtype_code is None:
        ints = np.all(data == np.round(data)) and data.size and data.max() < 65536 and data.min() >= 0
        dtype_code = 1 if ints else 0
    n, g = csr.shape
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        np.asarray([dtype_code, 0], np.uint32).tofile(fh)
        np.asarray([n, g, csr.nnz], np.uint64).tofile(fh)
        csr.indptr.astype(np.int64).tofile(fh)
        csr.indices.astype(np.int32).tofile(fh)
        if dtype_code == 1:
            data.astype(np.uint16).tofile(fh)
        else:
            data.astype(np.float32).tofile(fh)


def read_header(path: str):
    lib = get_lib()
    if lib is None:
        return _py_read_header(path)
    n = ctypes.c_uint64()
    g = ctypes.c_uint64()
    nnz = ctypes.c_uint64()
    dt = ctypes.c_uint32()
    rc = lib.sblk_read_header(path.encode(), n, g, nnz, dt)
    if rc != 0:
        raise IOError(f"sblk_read_header({path}) failed: rc={rc}")
    return int(n.value), int(g.value), int(nnz.value), int(dt.value)


def densify(path: str, n_threads: int = 0) -> np.ndarray:
    """Load an SBLK block as a dense (cells, genes) f32 array."""
    n, g, nnz, dt = read_header(path)
    lib = get_lib()
    if lib is None:
        return _py_densify(path)
    out = np.empty((n, g), np.float32)
    rc = lib.sblk_densify(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    if rc != 0:
        raise IOError(f"sblk_densify({path}) failed: rc={rc}")
    return out


# --- pure-python fallback (no toolchain) --------------------------------

def _py_parse(path: str):
    """Parse an SBLK file into (n, g, nnz, dt, indptr, indices, vals).

    The payload arrays are MEMORY-MAPPED read-only views of the file,
    not copies: a block's ~800 MB previously cost ~20 s to load on
    first-touch-fault-expensive VMs (np.fromfile + same-dtype astype =
    four fresh 400 MB anonymous allocations at a measured ~160 MB/s
    fault-in rate, vs 1.3+ GB/s disk and 3.6 GB/s reused-buffer
    copies). mmap defers to cheap page-cache minor faults at the
    moment the (much smaller) per-group slices are actually read.
    """
    with open(path, "rb") as fh:
        magic = fh.read(8)
        if magic != MAGIC:
            raise IOError(f"{path}: not an SBLK file")
        dt, _ = np.fromfile(fh, np.uint32, 2)
        n, g, nnz = np.fromfile(fh, np.uint64, 3)
        off = fh.tell()
    n, g, nnz, dt = int(n), int(g), int(nnz), int(dt)
    indptr = np.memmap(path, np.int64, mode="r", offset=off, shape=(n + 1,))
    off += (n + 1) * 8
    indices = np.memmap(path, np.int32, mode="r", offset=off, shape=(nnz,))
    off += nnz * 4
    vdt = np.uint16 if dt == 1 else np.float32
    vals = np.memmap(path, vdt, mode="r", offset=off, shape=(nnz,))
    return n, g, nnz, dt, indptr, indices, vals


def _py_read_header(path: str):
    n, g, nnz, dt, *_ = _py_parse(path)
    return n, g, nnz, dt


def _py_densify(path: str) -> np.ndarray:
    import scipy.sparse as sp

    n, g, nnz, dt, indptr, indices, vals = _py_parse(path)
    csr = sp.csr_matrix(
        (vals.astype(np.float32), indices, indptr), shape=(n, g)
    )
    return np.asarray(csr.todense(), np.float32)
