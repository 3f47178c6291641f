"""E-step execution backends behind the reference's mapper/reducer contract.

Counterpart of ``cpgisland_tpu/train/backends.py``, cut to the one-device
``local`` backend on the reduced (one-hot) engine.  The reference trains by
one MR job per EM iteration: mappers run forward-backward over 65,536-symbol
chunks and emit expected counts, the reduce sums them
(CpGIslandFinder.java:200-201).  Here the chunk batch is one tensor on the
card, every chunk one lane of the E-step kernels, and the reduce a sum over
lanes.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_chunked
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.ops.prepared import PreparedChunked, prepare_chunked
from cpgisland_tpu_torch.utils import chunking

# The reduced chains are K-free; the [K*K] stats accumulators bound K
# (the JAX package's ONEHOT_MAX_STATES).
ONEHOT_MAX_STATES = 32


def resolve_fb_engine(engine: str, params: HmmParams, mode: str) -> str:
    """The E-step engine for ``params``: "auto" picks "onehot" for a model
    with reduced-stats-eligible emissions (one-hot states in groups of 2,
    power-of-two alphabet) and K <= ONEHOT_MAX_STATES.  The generic
    ("xla") and dense ("pallas") engines and the log numerics are not
    ported, so every other model or request raises NotImplementedError."""
    if engine not in ("auto", "xla", "pallas", "onehot"):
        raise ValueError(f"unknown engine {engine!r}; expected auto|xla|pallas|onehot")
    if mode != "rescaled":
        raise NotImplementedError(
            f"numerics mode {mode!r}: only the rescaled E-step is ported (the "
            "generic engines of ROADMAP A2 carry the log numerics)"
        )
    if engine in ("xla", "pallas"):
        raise NotImplementedError(
            f"the {engine!r} E-step engine is not ported yet (ROADMAP A2/A10)"
        )
    if params.n_states > ONEHOT_MAX_STATES:
        raise NotImplementedError(
            f"{params.n_states} states: the onehot E-step takes at most "
            f"{ONEHOT_MAX_STATES}, and the dense engines are not ported yet"
        )
    if not family_partition.reduced_stats_eligible(params):
        raise NotImplementedError(
            "the model's emissions are not one-hot in groups of 2 over a "
            "power-of-two alphabet: only the reduced (onehot) E-step is ported "
            "(ROADMAP A2/A10)"
        )
    return "onehot"


class LocalBackend:
    """One device: the chunk batch is placed and its symbol streams are
    prepared once per fit; each call is one E-step over all chunks."""

    def __init__(self, mode: str = "rescaled", engine: str = "auto"):
        self.mode = mode
        self.engine = engine

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
        resolve_fb_engine(self.engine, params, self.mode)
        return prepare_chunked(params.n_symbols, chunks, lengths,
                               t_tile=fb_chunked.DEFAULT_T_TILE)

    def __call__(self, params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                 prepared: PreparedChunked) -> SuffStats:
        return fb_chunked.batch_stats(params, chunks, lengths, prepared=prepared)


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
