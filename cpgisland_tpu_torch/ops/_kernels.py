"""Build, load and launch the hand-written CUDA kernels.

The sources under ``cpgisland_tpu_torch/csrc/`` expose a plain C interface.
At first use they are compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/torch_kernels/`` beside the package (named by a
hash of source and flags, so an edited source rebuilds), and loaded with
ctypes.  Nothing is built or loaded at import time: the CPU tests import
every module, and the CPU has no ``nvcc``.

Every launch goes through :func:`launch`, which passes tensor pointers and
PyTorch's current stream, raises if the C function reports a CUDA error, and
adds one to the kernel's entry in :data:`launches` — the count a run reads
to show that its main path went through the kernels.
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

import torch

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "viterbi_onehot.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (pointer argument count); every function ends with (bk, nb, nP, stream).
_SIGNATURES = {
    "oh_products": 3,
    "oh_backpointers": 6,
    "oh_backtrace": 5,
}

# Launches per kernel since the last reset_launches(); incremented only where
# a kernel is launched.
launches = {name: 0 for name in _SIGNATURES}

# Set by the first build in this process: seconds spent and nvcc's report
# (-Xptxas -v: registers, shared memory and spills per kernel).
build_info: dict = {}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels are compiled at first use on a machine with the CUDA toolkit"
    )


def _build() -> Path:
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libviterbi_onehot_{tag}.so"
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["nvcc_report"] = proc.stderr
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, n_ptr in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_P] * n_ptr + [_I, _I, _I, _P]
                fn.restype = _I
            _lib = lib
        return _lib


def launch(name: str, *tensors: torch.Tensor, bk: int, nb: int, nP: int) -> None:
    """Launch kernel ``name`` on PyTorch's current stream with the tensors'
    device pointers (in the C function's order), then check the launch."""
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous CUDA tensors")
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    with torch.cuda.device(tensors[0].device):
        err = fn(*[t.data_ptr() for t in tensors], bk, nb, nP, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
