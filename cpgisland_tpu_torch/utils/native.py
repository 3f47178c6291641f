"""ctypes loader of the port's native codec (``csrc/codec.cpp``).

Counterpart of ``cpgisland_tpu/utils/native.py``.  The library is a host
library, not a kernel: at first use ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` builds it into ``build/torch_native/`` beside the package, named
by a hash of the source and the flags (as ``ops/_kernels.py`` names its
builds), under a temporary name that ``os.replace`` moves into place, so
several processes may build it at once.  Nothing is built at import time.

``CPGISLAND_NATIVE=0`` (the JAX package's switch, read under the same name)
selects the NumPy paths of ``utils.codec``; nothing else does.  A build or
load that fails raises with the compiler's report: there is no silent
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ABI = 101  # csrc/codec.cpp's cpg_native_abi()
_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "codec.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

# FASTA streaming-state bits (must match csrc/codec.cpp).
IN_HEADER = 1
AT_LINE_START = 2

# Segment slots of encode_mt's two-pass API: the C side never makes more
# segments than this (it clamps its threads to it).
MAX_SEGMENTS = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """False when ``CPGISLAND_NATIVE=0`` selects the NumPy paths."""
    return os.environ.get("CPGISLAND_NATIVE", "1") != "0"


def library_path() -> Path:
    """The built library's path: a hash of the source and the flags."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(BUILD_DIR) / f"libcpgcodec_{tag}.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native codec: cannot run {cxx!r} to build {SOURCE.name}: {e}; "
                           "set CPGISLAND_NATIVE=0 for the NumPy codec") from e
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"native codec: {cxx} failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, szp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_size_t)
    lib.cpg_native_abi.restype = ctypes.c_uint32
    lib.cpg_encode.restype = ctypes.c_size_t
    lib.cpg_encode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p]
    lib.cpg_encode_fasta.restype = ctypes.c_size_t
    lib.cpg_encode_fasta.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p,
                                     ctypes.POINTER(ctypes.c_uint32)]
    lib.cpg_count_segments.restype = ctypes.c_size_t
    lib.cpg_count_segments.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                       ctypes.c_int, szp, szp, ctypes.c_size_t]
    lib.cpg_encode_segments.restype = ctypes.c_size_t
    lib.cpg_encode_segments.argtypes = [ctypes.c_char_p, szp, szp, ctypes.c_size_t,
                                        ctypes.c_int, u8p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None when
    ``CPGISLAND_NATIVE=0``.  A failed build or load raises RuntimeError."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            try:
                lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise RuntimeError(f"native codec: cannot load {path}: {e}") from e
            if lib.cpg_native_abi() != _ABI:
                raise RuntimeError(f"native codec: {path} reports ABI "
                                   f"{lib.cpg_native_abi()}, expected {_ABI}")
            _lib = lib
        return _lib


def available() -> bool:
    """True when the native paths are selected (building the library on
    first call); False only under ``CPGISLAND_NATIVE=0``."""
    return load() is not None


def _compact(out: np.ndarray, n: int) -> np.ndarray:
    """Slice the encode output, copying when the slack is large: a bare
    ``out[:n]`` view pins the whole input-sized buffer, so a block that is
    mostly skipped bytes (N runs) would hold raw-bytes-read in memory
    instead of symbols-kept.  Dense blocks (newlines only, ~1.5% slack)
    keep the view."""
    if n < (out.size // 8) * 7:
        return out[:n].copy()
    return out[:n]


def _u8(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode(data: bytes) -> Optional[np.ndarray]:
    """Native twin of ``codec.encode_bytes`` (skip policy); None under
    ``CPGISLAND_NATIVE=0``."""
    lib = load()
    if lib is None:
        return None
    out = np.empty(len(data), dtype=np.uint8)
    return _compact(out, lib.cpg_encode(data, len(data), _u8(out)))


def encode_mt(data, *, fasta: bool = False, threads: int = 0) -> Optional[np.ndarray]:
    """Parallel whole-buffer (header-strip +) encode; None under
    ``CPGISLAND_NATIVE=0``.

    Two native passes (count, then write at exact per-segment offsets), so
    the output holds exactly the symbol count.  ``data`` is a complete
    buffer starting at a line start (bytes or a uint8 array); ``threads <=
    0`` means the hardware's concurrency (at least 4 MiB a thread)."""
    lib = load()
    if lib is None:
        return None
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8)
        buf, n = data.ctypes.data_as(ctypes.c_char_p), data.size
    else:
        buf, n = data, len(data)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    max_seg = MAX_SEGMENTS
    bounds = (ctypes.c_size_t * (max_seg + 1))()
    counts = (ctypes.c_size_t * max(max_seg, 1))()
    nseg = lib.cpg_count_segments(buf, n, int(fasta), threads, bounds, counts, max_seg)
    if nseg == 0:
        # n > 0 here, so 0 is the C API's capacity sentinel, never an empty result.
        raise RuntimeError(f"native cpg_count_segments needed more than {max_seg} segments")
    total = sum(counts[:nseg])
    out = np.empty(total, dtype=np.uint8)
    written = lib.cpg_encode_segments(buf, bounds, counts, nseg, int(fasta), _u8(out))
    if written != total:
        raise RuntimeError(f"native encode_mt wrote {written}, counted {total}")
    return out


class FastaEncoder:
    """Stateful fused header-strip + encode for streamed blocks (headers
    may span block boundaries)."""

    def __init__(self) -> None:
        self._state = ctypes.c_uint32(AT_LINE_START)
        self._lib = load()

    def feed(self, data: bytes) -> np.ndarray:
        if self._lib is None:
            raise RuntimeError("FastaEncoder: the native codec is disabled (CPGISLAND_NATIVE=0)")
        out = np.empty(len(data), dtype=np.uint8)
        n = self._lib.cpg_encode_fasta(data, len(data), _u8(out), ctypes.byref(self._state))
        return _compact(out, n)
