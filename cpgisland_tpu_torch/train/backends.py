"""E-step execution backends behind the reference's mapper/reducer contract.

Counterpart of ``cpgisland_tpu/train/backends.py``, cut to the one-device
``local`` backend on the reduced (one-hot) and dense ("pallas") kernel
engines.  The reference trains by
one MR job per EM iteration: mappers run forward-backward over 65,536-symbol
chunks and emit expected counts, the reduce sums them
(CpGIslandFinder.java:200-201).  Here the chunk batch is one tensor on the
card, every chunk one lane of the E-step kernels, and the reduce a sum over
lanes.
"""

from __future__ import annotations

from typing import Optional

import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_chunked, fb_pallas
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
