"""Prepared symbol streams: everything the chunked E-step derives from the
symbols alone.

Counterpart of ``cpgisland_tpu/ops/prepared.py``, cut to the chunked lane
layout of the reduced (one-hot) engine.  None of it depends on the model
parameters, so ``train.baum_welch.fit`` builds it ONCE per fit on the
device (from the uint8 chunks) and hands it to every EM iteration; the
identity-keyed cache of the JAX package is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from cpgisland_tpu_torch.ops.fb_onehot import decode_esym
from cpgisland_tpu_torch.ops.viterbi_onehot import ROW_TILE, pair_stream

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PreparedChunked:
    """Symbol-only prep for the chunked lane layout (one record per lane).

    steps2 [Tp, NL] int32 clamped symbols; lens2 [1, NL] int32; sel2
    [Tp, NL] PAD-marked selection symbols; pair2 / esym2 / pairn2 the
    reduced pair stream, its per-position emitted symbol and the
    time-shifted next-step pairs the backward chain consumes.  ``N`` x
    ``T`` is the chunk batch it was built for.  Lanes are not padded (NL ==
    N); steps pad to ``Tp``, a multiple of the t-tile ``Tt``."""

    steps2: torch.Tensor
    lens2: torch.Tensor
    sel2: torch.Tensor
    pair2: torch.Tensor
    esym2: torch.Tensor
    pairn2: torch.Tensor
    S: int
    Tt: int
    N: int
    T: int


def _pair_next(pair2: torch.Tensor, S: int) -> torch.Tensor:
    """Time-shifted next-step pair stream (the backward chain's input); the
    last row is S*S, which the kernels read as the identity."""
    NL = pair2.shape[1]
    tail = torch.full((1, NL), S * S, dtype=_I32, device=pair2.device)
    return torch.cat([pair2[1:], tail], dim=0)


def chunked_Tt(T: int, t_tile: int) -> int:
    """The t-tile of the chunked layout: ``min(t_tile, T)`` rounded up to a
    multiple of ROW_TILE (the JAX package's derivation, kept so both lay a
    batch out on the same [Tp, NL] geometry).  The B5 kernel reduces each
    lane in segments of Tt steps."""
    return -(-min(t_tile, T) // ROW_TILE) * ROW_TILE


def prepare_chunked(S: int, chunks: torch.Tensor, lengths: torch.Tensor, *,
                    t_tile: int) -> PreparedChunked:
    """Build the chunked-layout prep on the chunks' device.

    Positions inside a chunk's length are clamped to ``S - 1`` (a masked
    PAD inside a chunk counts as the last real symbol, as in the JAX
    package); positions past it become PAD steps of the pair stream."""
    N, T = chunks.shape
    dev = chunks.device
    lengths = lengths.to(device=dev, dtype=_I32)
    inside = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    obs_c = torch.where(inside, torch.clamp_max(chunks.to(_I32), S - 1), 0).to(_I32)
    Tt = chunked_Tt(T, t_tile)
    Tp = -(-T // Tt) * Tt
    steps2 = torch.zeros((Tp, N), dtype=_I32, device=dev)
    steps2[:T] = obs_c.T
    lens2 = lengths[None, :].contiguous()
    sel2 = torch.where(torch.arange(Tp, device=dev)[:, None] < lens2, steps2, S).to(_I32)
    # Lanes are independent records: the prev0 = 0 seed (and the symbol
    # the fill threads in from the previous lane) only reaches each lane's
    # position-0 pair, which no consumer reads (the forward's t == 0
    # override, the zero pair0 mask of the stats).
    pair2, _, _ = pair_stream(S, sel2, 0)
    return PreparedChunked(
        steps2=steps2, lens2=lens2, sel2=sel2, pair2=pair2,
        esym2=decode_esym(pair2, S), pairn2=_pair_next(pair2, S),
        S=S, Tt=Tt, N=int(N), T=int(T),
    )
