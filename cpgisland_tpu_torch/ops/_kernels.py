"""Build, load and launch the hand-written CUDA kernels.

The sources under ``cpgisland_tpu_torch/csrc/`` expose a plain C interface.
At first use each is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/torch_kernels/`` beside the package (named by
a hash of source, the shared headers ``csrc/*.cuh`` and flags, so an
edited source or header rebuilds) — one ``nvcc`` per source, all started
together — and loaded with ctypes.  Nothing is
built or loaded at import time: the CPU tests import every module, and the
CPU has no ``nvcc``.

Every launch goes through :func:`launch`, which passes tensor pointers,
the function's int arguments and PyTorch's current stream, raises if the C
function reports a CUDA error, and adds one to the kernel's entry in
:data:`launches` — the count a run reads to show that its main path went
through the kernels.
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
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (source stem under csrc/, pointer argument count, int argument
# names in the C function's order); every function ends with the stream.
_SIGNATURES = {
    "oh_products": ("viterbi_onehot", 3, ("bk", "nb", "nP")),
    "oh_backpointers": ("viterbi_onehot", 6, ("bk", "nb", "nP")),
    "oh_backpointers_scores": ("viterbi_onehot", 7, ("bk", "nb", "nP")),
    "oh_backtrace": ("viterbi_onehot", 5, ("bk", "nb", "nP", "seg")),
    "oh_products_stacked": ("viterbi_onehot", 3, ("bk", "nb", "nP", "M")),
    "oh_backpointers_stacked": ("viterbi_onehot", 6, ("bk", "nb", "nP", "M")),
    "oh_backpointers_stacked_scores": ("viterbi_onehot", 7, ("bk", "nb", "nP", "M")),
    "oh_backtrace_stacked": ("viterbi_onehot", 5, ("bk", "nb", "nP", "M", "seg")),
    "oh_prod": ("fb_onehot", 3, ("Tp", "NL", "nreal", "G")),
    "oh_fwdbwd": ("fb_onehot", 8, ("Tp", "NL", "nreal", "T", "G")),
    "oh_fwdbwd_mat": ("fb_onehot", 6, ("Tp", "NL", "nreal", "T")),
    "oh_seq_stats": ("fb_onehot", 14, ("Tp", "NL", "S", "K", "Tt", "SPB")),
    "oh_prod_stacked": ("fb_onehot", 3, ("Tp", "NL", "nreal", "G", "M")),
    "oh_fwdbwd_stacked": ("fb_onehot", 8, ("Tp", "NL", "nreal", "T", "G", "M")),
    "oh_fwd": ("fb_onehot", 6, ("Tp", "NL", "nreal", "G")),
    "oh_bwd": ("fb_onehot", 7, ("Tp", "NL", "nreal", "T", "G")),
    "oh_bwd_conf": ("fb_onehot", 10, ("Tp", "NL", "S", "T", "G")),
    "oh_stats": ("fb_onehot", 10, ("Tp", "NL", "S", "K", "Tt", "SPB")),
    "oh_fwd_stacked": ("fb_onehot", 6, ("Tp", "NL", "nreal", "G", "M")),
    "oh_bwd_stacked": ("fb_onehot", 7, ("Tp", "NL", "nreal", "T", "G", "M")),
    "oh_seq_stats_stacked": ("fb_onehot", 14, ("Tp", "NL", "S", "K", "Tt", "SPB", "M")),
    "oh_fwd_strm": ("fb_onehot", 4, ("Tp", "NL")),
    "oh_fwd_comp": ("fb_onehot", 4, ("H", "NL")),
    "oh_fwd_compsel": ("fb_onehot", 7, ("H", "NL", "S")),
    "oh_loglik": ("loglik", 4, ("Tp", "NL", "nreal", "G", "LB", "M")),
    "fb_loglik": ("loglik", 5, ("Tp", "NL", "K", "S", "G", "LB")),
    "dense_products": ("viterbi_dense", 4, ("bk", "nb", "K", "S")),
    "dense_backpointers": ("viterbi_dense", 7, ("bk", "nb", "K", "S")),
    "dense_backtrace": ("viterbi_dense", 3, ("bk", "nb", "K", "seg")),
    "fb_fwd": ("fb_dense", 7, ("Tp", "NL", "K", "S", "G")),
    "fb_prod": ("fb_dense", 3, ("Tp", "NL", "K", "S")),
    "fb_bwd": ("fb_dense", 8, ("Tp", "NL", "K", "S", "T", "G")),
    "fb_bwd_conf": ("fb_dense", 10, ("Tp", "NL", "K", "S", "T", "G")),
    "fb_stats": ("fb_dense", 9, ("Tp", "NL", "K", "S", "Tt")),
}
SOURCES = tuple(sorted({src for src, _, _ in _SIGNATURES.values()}))

# Launches per kernel since the last reset_launches(); incremented only where
# a kernel is launched.
launches = {name: 0 for name in _SIGNATURES}

# Set by the first build in this process: wall seconds of the parallel
# build, and nvcc's report per source (-Xptxas -v: registers, shared
# memory and spills per kernel).
build_info: dict = {}

_lock = threading.Lock()
_lib = None  # name -> loaded C function, once built


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


def _build_all() -> dict:
    """stem -> built library path; sources not built yet compile in
    parallel, one nvcc each."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    for stem in SOURCES:
        src = _CSRC / f"{stem}.cu"
        tag = hashlib.sha256(src.read_bytes() + headers
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{stem}_{tag}.so"
        out[stem] = lib
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[stem] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
    reports, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        reports[stem] = err
        if proc.returncode != 0:
            failed.append(f"{stem}.cu ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, out[stem])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0
    build_info["nvcc_report"] = reports
    return out


def library() -> dict:
    """name -> the loaded C function of every kernel, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            libs = {stem: ctypes.CDLL(str(path)) for stem, path in _build_all().items()}
            fns = {}
            for name, (stem, n_ptr, ints) in _SIGNATURES.items():
                fn = getattr(libs[stem], name)
                fn.argtypes = [_P] * n_ptr + [_I] * len(ints) + [_P]
                fn.restype = _I
                fns[name] = fn
            _lib = fns
        return _lib


def launch(name: str, *tensors: torch.Tensor, **ints: int) -> None:
    """Launch kernel ``name`` on PyTorch's current stream with the tensors'
    device pointers (in the C function's order) and its int arguments (by
    name), then check the launch."""
    _, n_ptr, names = _SIGNATURES[name]
    if len(tensors) != n_ptr or set(ints) != set(names):
        raise TypeError(f"{name} takes {n_ptr} tensors and the ints {names}")
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous CUDA tensors")
    fn = library()[name]
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    with torch.cuda.device(tensors[0].device):
        err = fn(*[t.data_ptr() for t in tensors], *[int(ints[k]) for k in names], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
