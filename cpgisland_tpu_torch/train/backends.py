"""E-step execution backends behind the reference's mapper/reducer contract.

Counterpart of ``cpgisland_tpu/train/backends.py``, cut to the one-device
``local`` backend on the reduced (one-hot) and dense ("pallas") kernel
engines.  The reference trains by
one MR job per EM iteration: mappers run forward-backward over 65,536-symbol
chunks and emit expected counts, the reduce sums them
(CpGIslandFinder.java:200-201).  Here the chunk batch is one tensor on the
card, every chunk one lane of the E-step kernels, and the reduce a sum over
lanes.  :class:`FamilyEStep` and :func:`fit_family` train M reduced
members of one alphabet in lockstep through the stacked kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_chunked, fb_onehot, fb_pallas
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.ops.prepared import PreparedChunked, prepare_chunked
from cpgisland_tpu_torch.utils import chunking

# The reduced chains are K-free; the [K*K] stats accumulators bound K
# (the JAX package's ONEHOT_MAX_STATES).
ONEHOT_MAX_STATES = 32


def resolve_fb_engine(engine: str, params: HmmParams, mode: str) -> str:
    """The E-step engine for ``params``, as the JAX router picks it on its
    TPU: "auto" takes "onehot" for a model with reduced-stats-eligible
    emissions (one-hot states in groups of 2, power-of-two alphabet) and
    K <= ONEHOT_MAX_STATES, else "pallas" (the dense kernels) where
    ``fb_pallas.supports`` the model (K <= 8).  An explicit "pallas" or
    "onehot" is honoured where its kernels fit.  The generic "xla" engine
    and the log numerics (ROADMAP A2) are not ported: asking for them, or
    "auto" for a model neither kernel engine takes, raises
    NotImplementedError."""
    if engine not in ("auto", "xla", "pallas", "onehot"):
        raise ValueError(f"unknown engine {engine!r}; expected auto|xla|pallas|onehot")
    if mode != "rescaled":
        raise NotImplementedError(
            f"numerics mode {mode!r}: only the rescaled E-step is ported (the "
            "generic engines of ROADMAP A2 carry the log numerics)"
        )
    if engine == "xla":
        raise NotImplementedError(
            "the generic 'xla' E-step engine is not ported yet (ROADMAP A2)"
        )
    onehot_ok = (params.n_states <= ONEHOT_MAX_STATES
                 and family_partition.reduced_stats_eligible(params))
    if engine == "auto":
        if onehot_ok:
            return "onehot"
        if fb_pallas.supports(params):
            return "pallas"
        raise NotImplementedError(
            f"{params.n_states} states over {params.n_symbols} symbols: outside the "
            "reduced E-step's domain and the dense kernels' (K <= "
            f"{fb_pallas.MAX_STATES}, S <= {fb_pallas.MAX_SYMBOLS}); the generic "
            "'xla' engine is not ported yet (ROADMAP A2)"
        )
    if engine == "pallas" and not fb_pallas.supports(params):
        raise ValueError(
            f"pallas E-step kernels need n_states <= {fb_pallas.MAX_STATES} and "
            f"n_symbols <= {fb_pallas.MAX_SYMBOLS}, got {params.n_states} / "
            f"{params.n_symbols}"
        )
    if engine == "onehot" and not onehot_ok:
        raise ValueError(
            "engine='onehot' needs emissions one-hot in groups of 2 over a "
            f"power-of-two alphabet and at most {ONEHOT_MAX_STATES} states"
        )
    return engine


class LocalBackend:
    """One device: the chunk batch is placed and its symbol streams are
    prepared once per fit; each call is one E-step over all chunks on the
    engine resolved in :meth:`prepare_streams`."""

    def __init__(self, mode: str = "rescaled", engine: str = "auto"):
        self.mode = mode
        self.engine = engine
        self.resolved: Optional[str] = None

    def place(self, chunked: chunking.Chunked, device) -> tuple:
        """Upload the uint8 chunks and their lengths once, before the loop."""
        chunks = torch.from_numpy(chunked.chunks).to(device)
        lengths = torch.from_numpy(chunked.lengths).to(device)
        return chunks, lengths

    def prepare_streams(self, params: HmmParams, chunks: torch.Tensor,
                        lengths: torch.Tensor) -> PreparedChunked:
        """The symbol-only prep of the placed batch (built on its device).
        The engine resolves here, once per fit: it reads the emission
        structure on the host, and EM keeps that structure (structural
        zeros are fixed points), so the iterations need not re-resolve."""
        self.resolved = resolve_fb_engine(self.engine, params, self.mode)
        return prepare_chunked(params.n_symbols, chunks, lengths,
                               t_tile=fb_chunked.DEFAULT_T_TILE,
                               onehot=self.resolved == "onehot")

    def __call__(self, params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                 prepared: PreparedChunked) -> SuffStats:
        if self.resolved is None:
            raise RuntimeError("LocalBackend: call prepare_streams before the E-step")
        return fb_chunked.batch_stats(params, chunks, lengths, prepared=prepared,
                                      engine=self.resolved)


class FamilyEStep:
    """Stacked E-step of M model-family members (reduced-stats-eligible,
    one alphabet) over ONE shared chunk batch: every member's chains in one
    launch of B24 and its counts in one of B25 (``fb_chunked.
    batch_stats_stacked``).  Member m's statistics equal
    ``LocalBackend(engine="onehot")``'s bit for bit.  ``stacked=False`` is
    the sequential arm: M single-model reduced E-steps over the same placed
    batch and prep.  The JAX package's ``None`` defaults read its tuner
    table, which the port does not have (ROADMAP A14): here ``None`` means
    True.  ``fuse_fb=False`` (the split arm, B22 / B23) is not ported."""

    def __init__(self, t_tile: Optional[int] = None, fuse_fb: Optional[bool] = None,
                 stacked: Optional[bool] = None):
        if fuse_fb is False:
            raise NotImplementedError(
                "FamilyEStep(fuse_fb=False): the stacked split arm (kernels B22, B23) is "
                "not ported yet (ROADMAP A14)"
            )
        self.t_tile = fb_chunked.DEFAULT_T_TILE if t_tile is None else int(t_tile)
        self.fuse_fb = True
        self.stacked = True if stacked is None else bool(stacked)

    def validate(self, params_list) -> None:
        fb_onehot.check_stacked_members(params_list)
        for p in params_list:
            if not (family_partition.reduced_stats_eligible(p)
                    and p.n_states <= ONEHOT_MAX_STATES):
                raise ValueError(
                    "FamilyEStep members must be reduced-stats-eligible (one-hot emissions "
                    "in groups of 2 over a power-of-two alphabet, at most "
                    f"{ONEHOT_MAX_STATES} states)"
                )

    def place(self, chunks, lengths, device) -> tuple:
        """The uint8 chunks and their lengths on ``device``, uploaded once."""
        return (torch.as_tensor(chunks).to(device), torch.as_tensor(lengths).to(device))

    def prepare_streams(self, params_list, chunks: torch.Tensor,
                        lengths: torch.Tensor) -> PreparedChunked:
        """ONE symbol-only prep for every member: the pair stream depends on
        the symbols and the alphabet only."""
        return prepare_chunked(params_list[0].n_symbols, chunks, lengths, t_tile=self.t_tile,
                               onehot=True)

    def __call__(self, params_list, chunks: torch.Tensor, lengths: torch.Tensor,
                 prepared: Optional[PreparedChunked] = None) -> tuple:
        params_list = tuple(params_list)
        self.validate(params_list)
        if prepared is None:
            prepared = self.prepare_streams(params_list, chunks, lengths)
        if not self.stacked:
            return tuple(fb_chunked.batch_stats(p, chunks, lengths, prepared=prepared,
                                                engine="onehot") for p in params_list)
        return fb_chunked.batch_stats_stacked(params_list, chunks, lengths, prepared=prepared)


def fit_family(params_list, chunks, lengths, *, n_iter: int = 10,
               estep: Optional[FamilyEStep] = None):
    """Train M family members in LOCKSTEP over one chunk batch (``chunks``
    [N, T] uint8, ``lengths`` [N], arrays or tensors) on the first
    member's device: each iteration runs ONE stacked E-step and M M-steps.
    Member m's trajectory equals ``baum_welch.fit`` of that member alone
    (onehot engine, convergence 0) bit for bit.  No host sync inside the
    loop: the logliks come back once, after it.  Returns (trained params
    list, logliks [n_iter, M] float64)."""
    from cpgisland_tpu_torch.train.baum_welch import mstep

    estep = estep if estep is not None else FamilyEStep()
    dev = params_list[0].device
    params_list = [HmmParams(p.log_pi.float(), p.log_A.float(), p.log_B.float())
                   for p in params_list]
    chunks, lengths = estep.place(chunks, lengths, dev)
    prep = estep.prepare_streams(params_list, chunks, lengths)
    hist = []
    for _ in range(int(n_iter)):
        stats = estep(params_list, chunks, lengths, prepared=prep)
        hist.append(torch.stack([st.loglik.float() for st in stats]))
        params_list = [mstep(p, st) for p, st in zip(params_list, stats)]
    if not hist:
        return params_list, np.zeros((0, len(params_list)), np.float64)
    return params_list, torch.stack(hist).double().cpu().numpy()


def get_backend(name: str = "local", *, mode: str = "rescaled",
                engine: str = "auto") -> LocalBackend:
    """Backend factory; only ``local`` is ported."""
    if name == "local":
        return LocalBackend(mode=mode, engine=engine)
    if name in ("spmd", "seq", "seq2d"):
        raise NotImplementedError(
            f"backend {name!r} is not ported yet (multi-GPU: ROADMAP A9; "
            "whole-sequence EM: A8)"
        )
    raise ValueError(
        f"unknown backend {name!r} (expected 'local', 'spmd', 'seq', or 'seq2d')"
    )
