"""Baum-Welch EM: the M-step and the convergence-driven training loop.

Counterpart of ``cpgisland_tpu/train/baum_welch.py``.  The reference's
trainer is Mahout's Baum-Welch driver: per iteration one MR job (mappers:
forward-backward counts; reducers: sum and normalize), looping until
|model_{t+1} - model_t| < convergence or numIter jobs have run
(CpGIslandFinder.java:200-201; convergence ".005" at :96).  Here the E-step
runs through a :class:`~cpgisland_tpu_torch.train.backends.LocalBackend`,
the M-step is a normalize on the card, and the loop is host Python with one
device sync per iteration: the fetch of that iteration's delta and loglik.

Structural zeros (the one-hot emission rows of the CpG model) are EM fixed
points: a zero-probability emission accumulates exactly zero expected
count.  Rows with zero total count keep their previous distribution.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Optional, Union

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.train.backends import LocalBackend, get_backend
from cpgisland_tpu_torch.utils import chunking

log = logging.getLogger(__name__)


def mstep(params: HmmParams, stats: SuffStats) -> HmmParams:
    """Normalize expected counts into the next model, on the stats' device.
    Zero-count rows retain the previous distribution."""

    def normalize(counts, prev_probs):
        row = torch.sum(counts, dim=-1, keepdim=True)
        return torch.where(row > 0, counts / torch.clamp_min(row, 1e-30), prev_probs)

    pi = normalize(stats.init, params.pi)
    A = normalize(stats.trans, params.A)
    B = normalize(stats.emit, params.B)
    return HmmParams.from_probs(pi, A, B)


def em_update(params: HmmParams, stats: SuffStats):
    """M-step plus the convergence delta -> (new_params, delta 0-d tensor)."""
    new_params = mstep(params, stats)
    return new_params, new_params.max_abs_diff(params)


@dataclasses.dataclass
class FitResult:
    params: HmmParams
    iterations: int
    logliks: list
    converged: bool
    deltas: list
    # (iteration, reason) records of mid-training recoveries; the port has
    # no recovery path yet, so this stays empty.
    recoveries: list = dataclasses.field(default_factory=list)
    # Seconds per phase: "prepare" (upload + symbol-stream prep), "estep"
    # and "mstep" (device time between CUDA events, summed over the
    # iterations; host time on the CPU), "em" (the loop's wall time).
    # train_file adds "encode".
    phases: dict = dataclasses.field(default_factory=dict)


class _Stopwatch:
    """Phase times without host syncs: CUDA events on the card (read once,
    after the loop), the host clock on the CPU (where every op is
    synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def fit(
    params: HmmParams,
    chunked: chunking.Chunked,
    *,
    num_iters: int = 10,
    convergence: float = 0.005,
    backend: Union[LocalBackend, str] = "local",
    mode: str = "rescaled",
    engine: str = "auto",
    checkpoint_dir: Optional[str] = None,
    callback=None,
    start_iteration: int = 0,
    fallback_backend=None,
    fuse: Union[bool, str] = "auto",
) -> FitResult:
    """Run Baum-Welch EM on ``params``' device until the max-abs change of
    any model probability drops below ``convergence``, or for ``num_iters``
    iterations.

    ``fuse``: "auto" (and False / "off") run the host loop; the JAX
    package's fused loop has the same semantics, so the results are the
    same.  ``fuse=True`` (the on-device loop, ROADMAP A8), checkpoints,
    callbacks, a fallback backend and resumed numbering (A12) raise
    NotImplementedError."""
    if fuse not in (True, False, "auto", "on", "off"):
        raise ValueError(f"fuse must be auto|True|False, got {fuse!r}")
    if fuse is True or fuse == "on":
        raise NotImplementedError("the on-device EM loop (fuse=True) is not ported yet (ROADMAP A8)")
    for what, value in (("checkpoint_dir", checkpoint_dir), ("callback", callback),
                        ("fallback_backend", fallback_backend),
                        ("start_iteration", start_iteration)):
        if value:
            raise NotImplementedError(f"fit({what}=...) is not ported yet (ROADMAP A12)")
    if isinstance(backend, str):
        backend = get_backend(backend, mode=mode, engine=engine)
    dev = params.device
    params = HmmParams(params.log_pi.float(), params.log_A.float(), params.log_B.float())
    watch = _Stopwatch(dev)
    t0 = time.perf_counter()
    chunks, lengths = backend.place(chunked, dev)
    prep = backend.prepare_streams(params, chunks, lengths)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases = {"prepare": time.perf_counter() - t0, "estep": 0.0, "mstep": 0.0}

    logliks: list = []
    deltas: list = []
    converged = False
    it = 0
    t0 = time.perf_counter()
    for it in range(1, num_iters + 1):
        watch.mark()
        stats = backend(params, chunks, lengths, prepared=prep)
        watch.mark()
        new_params, delta_dev = em_update(params, stats)
        watch.mark()
        # The one host sync of the iteration (the reference's one MR job).
        delta, ll = torch.stack([delta_dev, stats.loglik.float()]).tolist()
        params = new_params
        logliks.append(ll)
        deltas.append(delta)
        log.info("em iter=%d loglik=%.4f delta=%.6f", it, ll, delta)
        if not (math.isfinite(ll) and math.isfinite(delta)):
            # delta is NaN when any new probability is: the model stays the
            # restart point, so a blowup is a hard error.
            raise FloatingPointError(f"em iter {it}: loglik={ll} delta={delta}")
        if delta < convergence:
            converged = True
            break
    phases["em"] = time.perf_counter() - t0
    for i in range(0, len(watch.marks), 3):
        phases["estep"] += watch.seconds(i, i + 1)
        phases["mstep"] += watch.seconds(i + 1, i + 2)
    return FitResult(
        params=params, iterations=it, logliks=logliks, converged=converged,
        deltas=deltas, phases=phases,
    )
