"""Baum-Welch EM: the M-step and the convergence-driven training loop.

Counterpart of ``cpgisland_tpu/train/baum_welch.py``.  The reference's
trainer is Mahout's Baum-Welch driver: per iteration one MR job (mappers:
forward-backward counts; reducers: sum and normalize), looping until
|model_{t+1} - model_t| < convergence or numIter jobs have run
(CpGIslandFinder.java:200-201; convergence ".005" at :96).  Here the E-step
runs through a backend of ``train.backends`` (chunked ``local``, or the
whole-sequence ``seq`` / ``seq2d``), the M-step is a normalize on the card,
and the loop runs one of two ways.  The host loop (``fuse="off"``) blocks
once per iteration on the fetch of that iteration's delta and loglik (the
reference's one MR job).  The device loop (``fuse="auto"`` / "on") makes
no blocking read between iterations: each iteration's (delta, loglik,
converged) goes to pinned host memory by an asynchronous copy behind an
event, and the host reads iteration i's flag only after it has enqueued
iteration i+1, so the card always has work while the host waits.  At most
one E-step runs past convergence; it is discarded.  Both loops run the
same float32 operations, so their results are equal bit for bit.

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
from cpgisland_tpu_torch.train.backends import get_backend
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


def _fetch(x: torch.Tensor) -> list:
    """The host loop's one blocking device-to-host read an iteration."""
    return x.tolist()


def _parse_fuse(fuse) -> bool:
    """True for the device loop ("auto", True, "on"), False for the host
    loop (False, "off"), as the JAX package parses ``fuse``."""
    if fuse not in (True, False, "auto", "on", "off"):
        raise ValueError(f"fuse must be auto|True|False, got {fuse!r}")
    fuse = {"on": True, "off": False}.get(fuse, fuse)
    return fuse == "auto" or bool(fuse)


def fit(
    params: HmmParams,
    chunked,
    *,
    num_iters: int = 10,
    convergence: float = 0.005,
    backend="local",
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

    ``backend``: a name (``get_backend``: local | spmd | seq | seq2d) or an
    instance; a mesh backend's mesh defaults to ``params``' device (a
    caller that wants every local card binds the backend to "cuda" first,
    as ``pipeline.train_file`` does), and the model moves to the mesh's
    first entry, where the statistics are summed and the M-step runs (the
    next E-step copies it to every entry without a blocking read).  Its
    ``prepare`` lays ``chunked`` out (a Chunked, or a Bucketed batch of
    records for seq2d) before one upload and one symbol-stream prep.
    ``fuse``: "auto", True or "on" run the device loop, False or "off" the
    host loop (the module docstring); the results are equal bit for bit.
    The device loop raises FloatingPointError after the loop when a loglik
    or delta is not finite (the host loop at that iteration); a failed
    device loop raises, with no fallback to the host loop.  Checkpoints, callbacks, a fallback
    backend and resumed numbering (ROADMAP A12) raise
    NotImplementedError."""
    device_loop = _parse_fuse(fuse)
    for what, value in (("checkpoint_dir", checkpoint_dir), ("callback", callback),
                        ("fallback_backend", fallback_backend),
                        ("start_iteration", start_iteration)):
        if value:
            raise NotImplementedError(f"fit({what}=...) is not ported yet (ROADMAP A12)")
    if isinstance(backend, str):
        backend = get_backend(backend, mode=mode, engine=engine)
    # A mesh backend builds its default mesh on the model's device, and the
    # model lives on the mesh's first entry, where the statistics are
    # summed and the M-step runs.
    if hasattr(backend, "bind"):
        backend.bind(params.device)
    home = getattr(backend, "home", None)
    if home is not None:
        params = params.to(home)
    dev = params.device
    params = HmmParams(params.log_pi.float(), params.log_A.float(), params.log_B.float())
    t0 = time.perf_counter()
    chunked = backend.prepare(chunked)
    chunks, lengths = backend.place(chunked, dev)
    prep = backend.prepare_streams(params, chunks, lengths)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases = {"prepare": time.perf_counter() - t0, "estep": 0.0, "mstep": 0.0}

    def iteration(p, watch):
        watch.mark()
        stats = backend(p, chunks, lengths, prepared=prep)
        watch.mark()
        new_p, delta = em_update(p, stats)
        watch.mark()
        return new_p, delta, stats.loglik.float()

    watch = _Stopwatch(dev)
    t0 = time.perf_counter()
    loop = _device_loop if device_loop else _host_loop
    params, logliks, deltas, converged = loop(params, iteration, watch, num_iters, convergence)
    phases["em"] = time.perf_counter() - t0
    for i in range(0, 3 * len(logliks), 3):
        phases["estep"] += watch.seconds(i, i + 1)
        phases["mstep"] += watch.seconds(i + 1, i + 2)
    return FitResult(
        params=params, iterations=len(logliks), logliks=logliks, converged=converged,
        deltas=deltas, phases=phases,
    )


def _host_loop(params, iteration, watch, num_iters: int, convergence: float):
    logliks: list = []
    deltas: list = []
    for it in range(1, num_iters + 1):
        params, delta_dev, ll_dev = iteration(params, watch)
        # The one host sync of the iteration (the reference's one MR job).
        delta, ll = _fetch(torch.stack([delta_dev, ll_dev]))
        logliks.append(ll)
        deltas.append(delta)
        log.info("em iter=%d loglik=%.4f delta=%.6f", it, ll, delta)
        if not (math.isfinite(ll) and math.isfinite(delta)):
            # delta is NaN when any new probability is: the model stays the
            # restart point, so a blowup is a hard error.
            raise FloatingPointError(f"em iter {it}: loglik={ll} delta={delta}")
        if delta < convergence:
            return params, logliks, deltas, True
    return params, logliks, deltas, False


def _device_loop(params, iteration, watch, num_iters: int, convergence: float):
    """Iteration i+1 is enqueued before the host waits for iteration i's
    (delta, loglik, converged), which an asynchronous copy puts in pinned
    memory behind an event; the E-step run past convergence is dropped."""
    cuda = params.device.type == "cuda"
    # One pinned row per iteration, allocated before the loop: a pinned
    # allocation inside it could stall the host on the device.
    host = torch.empty((max(num_iters, 1), 3), dtype=torch.float32, pin_memory=cuda)
    pending = []  # per enqueued iteration: (its new params, host row, event)
    logliks: list = []
    deltas: list = []

    def settle(it):
        new_p, buf, ev = pending[it - 1]
        if ev is not None:
            ev.synchronize()
        delta, ll, conv = buf.tolist()
        logliks.append(ll)
        deltas.append(delta)
        log.info("em iter=%d loglik=%.4f delta=%.6f (device loop)", it, ll, delta)
        return new_p, conv != 0.0

    for it in range(1, num_iters + 1):
        params, delta_dev, ll_dev = iteration(params, watch)
        # The test in float64, as the host loop compares the fetched delta.
        vals = torch.stack([delta_dev, ll_dev, (delta_dev.double() < convergence).float()])
        buf = host[it - 1]
        buf.copy_(vals, non_blocking=cuda)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        pending.append((params, buf, ev))
        if it > 1:
            new_p, conv = settle(it - 1)
            if conv:
                # Iteration it ran past convergence: dropped, marks too.
                del watch.marks[3 * (it - 1):]
                return _finish(new_p, logliks, deltas, True)
    if pending:
        new_p, conv = settle(len(pending))
        return _finish(new_p, logliks, deltas, conv)
    return params, logliks, deltas, False


def _finish(params, logliks, deltas, converged):
    bad = [i + 1 for i, (ll, d) in enumerate(zip(logliks, deltas))
           if not (math.isfinite(ll) and math.isfinite(d))]
    if bad:
        it = bad[0]
        raise FloatingPointError(
            f"em iter {it}: loglik={logliks[it - 1]} delta={deltas[it - 1]} (device loop, "
            f"{len(logliks)} iterations)")
    return params, logliks, deltas, converged
