"""Prepared symbol streams: everything the forward-backward kernels'
callers derive from the symbols alone.

Counterpart of ``cpgisland_tpu/ops/prepared.py``: the chunked lane layout
(one record per lane) and the whole-sequence lane layout of one span, for
the reduced (one-hot) engine, which reads the pair stream, and for the
dense engine, which reads the clamped symbols.  None of it depends on the model
parameters, so ``train.baum_welch.fit`` builds the chunked prep ONCE per
fit on the device (from the uint8 chunks) and hands it to every EM
iteration, and ``pipeline.posterior_file`` builds one span's prep once for
both of its sweeps.  :func:`cached_build` and :func:`for_seq` keep the
JAX package's identity-keyed cache: an entry is keyed on the placed input
tensors (through weak references, so a dead input frees its entry) plus a
static key, so a whole-sequence E-step called outside ``fit`` builds its
prep once per placed input, not once per call.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import OrderedDict
from typing import Optional

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
    time-shifted next-step pairs the backward chain consumes (None for
    the dense engine, which reads steps2 and lens2 only).  ``N`` x ``T``
    is the chunk batch it was built for.  Lanes are not padded (NL == N);
    steps pad to ``Tp``, a multiple of the t-tile ``Tt``."""

    steps2: torch.Tensor
    lens2: torch.Tensor
    sel2: torch.Tensor
    pair2: Optional[torch.Tensor]
    esym2: Optional[torch.Tensor]
    pairn2: Optional[torch.Tensor]
    S: int
    Tt: int
    N: int
    T: int
    onehot: bool = True


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
                    t_tile: int, onehot: bool = True) -> PreparedChunked:
    """Build the chunked-layout prep on the chunks' device; the pair
    stream only for the reduced engine (``onehot``).

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
    if not onehot:
        return PreparedChunked(steps2=steps2, lens2=lens2, sel2=sel2, pair2=None, esym2=None,
                               pairn2=None, S=S, Tt=Tt, N=int(N), T=int(T), onehot=False)
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


@dataclasses.dataclass(frozen=True)
class PreparedSeq:
    """Symbol-only prep for the whole-sequence lane layout of one span.

    first_syms [NL] int32 each lane's first clamped symbol (its v_0
    emission); lane_lens [NL] int32; o0 the span's first clamped symbol (a
    Python int).  The reduced engine (``onehot``) reads pair2 / e_in /
    e_out, the pair stream ([lane_T, NL]) and each lane's entry / exit
    symbol, and pairn2, its time-shifted next-step pairs (the backward
    chain's input); the dense engine reads the time-major lane layouts
    steps2 (clamped symbols) and sel2 (PAD-marked: the products' input).
    Each prep carries only its engine's streams.  ``T`` is the span's input
    length (NL rounds up, so different T can share a lane shape) and
    ``prev_key`` the continuation prev symbol it was built for (None on a
    first span and for the dense engine, which needs none)."""

    first_syms: torch.Tensor
    lane_lens: torch.Tensor
    o0: int
    pair2: Optional[torch.Tensor]
    e_in: Optional[torch.Tensor]
    e_out: Optional[torch.Tensor]
    pairn2: Optional[torch.Tensor]
    S: int
    lane_T: int
    first: bool
    T: int
    prev_key: Optional[int]
    onehot: bool = True
    steps2: Optional[torch.Tensor] = None
    sel2: Optional[torch.Tensor] = None


def _lane_layout(obs: torch.Tensor, length: int, S: int, lane_T: int, mask_first: bool):
    """Pad one sequence into [NL, lane_T] lanes, NL = ceil(T / lane_T)
    (the JAX package also rounds NL up to its 128-lane tile; the extra
    lanes are empty, identity products).  Valid positions are clamped to
    [0, S); with ``mask_first`` global position 0's step becomes PAD (its
    emission is the init, folded into the base direction by the consumer).
    Returns (obs_l [NL, lane_T], sel_l — obs_l with PAD on invalid steps —,
    lane_lens [NL], o0)."""
    T = obs.shape[0]
    dev = obs.device
    NL = max(1, -(-T // lane_T))
    valid = torch.arange(T, device=dev) < length
    obs_flat = torch.where(valid, torch.clamp_max(obs.to(_I32), S - 1), 0).to(_I32)
    sel_flat = torch.where(valid, obs_flat, S).to(_I32)
    if mask_first and T:
        sel_flat[0] = S
    pad = NL * lane_T - T
    obs_l = torch.nn.functional.pad(obs_flat, (0, pad)).reshape(NL, lane_T)
    sel_l = torch.nn.functional.pad(sel_flat, (0, pad), value=S).reshape(NL, lane_T)
    lane_lens = torch.clamp(length - torch.arange(NL, device=dev) * lane_T, 0, lane_T).to(_I32)
    o0 = int(obs_flat[0]) if T else 0
    return obs_l, sel_l, lane_lens, o0


def prepare_seq(S: int, obs: torch.Tensor, length: int, *, lane_T: int, first: bool = True,
                prev_sym: Optional[int] = None, onehot: bool = True) -> PreparedSeq:
    """Build one span's whole-sequence prep on ``obs``'s device, for the
    reduced engine (``onehot``) or the dense one.  A reduced continuation
    span (``first=False``) needs ``prev_sym``, the symbol emitted before
    it: it conditions the reduced chain's entry group.  The dense engine
    takes none."""
    if lane_T <= 0:
        raise ValueError(f"lane_T must be positive, got {lane_T}")
    if onehot and not first and prev_sym is None:
        raise ValueError("onehot continuation spans (first=False) need prev_sym")
    obs_l, sel_l, lane_lens, o0 = _lane_layout(obs, int(length), S, lane_T, bool(first))
    if not onehot:
        return PreparedSeq(
            first_syms=obs_l[:, 0].contiguous(), lane_lens=lane_lens, o0=o0, pair2=None,
            e_in=None, e_out=None, pairn2=None, S=S, lane_T=int(lane_T), first=bool(first),
            T=int(obs.shape[0]), prev_key=None, onehot=False,
            steps2=obs_l.T.contiguous(), sel2=sel_l.T.contiguous(),
        )
    # One copy into the time-major layout: the streams handed to the kernels
    # are then contiguous.
    pair2, e_in, e_out = pair_stream(S, sel_l.T.contiguous(), o0 if first else int(prev_sym))
    return PreparedSeq(
        first_syms=obs_l[:, 0].contiguous(), lane_lens=lane_lens, o0=o0,
        pair2=pair2, e_in=e_in, e_out=e_out, pairn2=_pair_next(pair2, S), S=S,
        lane_T=int(lane_T), first=bool(first), T=int(obs.shape[0]),
        prev_key=None if first else int(prev_sym),
    )


def check_seq(prep: PreparedSeq, S: int, T: int, lane_T: int, first: bool,
              prev_sym=None, onehot: bool = True) -> None:
    """Consistency gate between a span's prep and its consumer: a mismatch
    raises instead of computing on the wrong layout, engine or entry
    symbol."""
    if not isinstance(prep, PreparedSeq):
        raise TypeError(f"expected PreparedSeq, got {type(prep).__name__}")
    if prep.onehot != bool(onehot):
        raise ValueError(
            f"prepared seq streams were built for the {'onehot' if prep.onehot else 'dense'} "
            f"engine; this call runs the {'onehot' if onehot else 'dense'} one"
        )
    if (prep.S, prep.lane_T, prep.first, prep.T) != (S, lane_T, bool(first), int(T)):
        raise ValueError(
            f"prepared seq streams were built for S={prep.S}, T={prep.T}, "
            f"lane_T={prep.lane_T}, first={prep.first}; this call needs S={S}, "
            f"T={int(T)}, lane_T={lane_T}, first={bool(first)} — rebuild the "
            "prep for this geometry"
        )
    if prep.prev_key is not None and prev_sym is not None and int(prev_sym) != prep.prev_key:
        raise ValueError(
            f"prepared seq streams were conditioned on prev_sym={prep.prev_key}; "
            f"this call passes prev_sym={int(prev_sym)} — rebuild the prep for "
            "this span"
        )


# ---------------------------------------------------------------------------
# The identity-keyed cache

_CACHE_MAX = 8
_CACHE_LOCK = threading.Lock()
# (kind, static key, ids of the keyed tensors) -> (weak refs, prep)
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
_stats = {"hits": 0, "misses": 0, "evictions_dead": 0, "evictions_capacity": 0}


def cache_stats() -> dict:
    """Hit / miss / eviction counters since process start (or
    :func:`clear_cache`), plus the number of live ``entries``."""
    with _CACHE_LOCK:
        return dict(_stats, entries=len(_cache))


def clear_cache() -> None:
    with _CACHE_LOCK:
        _cache.clear()
        for k in _stats:
            _stats[k] = 0


def _live(ent, tensors) -> bool:
    return ent is not None and all(r() is t for r, t in zip(ent[0], tensors))


def cached_build(kind: str, tensors: tuple, skey: tuple, build):
    """``build()``'s result, cached on the identity of ``tensors`` (held
    by weak reference) and the static key ``skey``.  An entry whose
    tensors died is dropped at the next miss; at most ``_CACHE_MAX``
    entries are kept (oldest first out)."""
    key = (kind, skey, tuple(id(t) for t in tensors))
    with _CACHE_LOCK:
        ent = _cache.get(key)
        if _live(ent, tensors):
            _cache.move_to_end(key)
            _stats["hits"] += 1
            return ent[1]
        if ent is not None:  # the id was recycled onto a new tensor
            del _cache[key]
            _stats["evictions_dead"] += 1
        dead = [k for k, e in _cache.items() if any(r() is None for r in e[0])]
        for k in dead:
            del _cache[k]
        _stats["evictions_dead"] += len(dead)
    prep = build()
    with _CACHE_LOCK:
        _stats["misses"] += 1
        _cache[key] = (tuple(weakref.ref(t) for t in tensors), prep)
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
            _stats["evictions_capacity"] += 1
    return prep


def for_seq(S: int, obs: torch.Tensor, length: int, *, lane_T: int, first: bool = True,
            onehot: bool = True, prev_sym: Optional[int] = None) -> PreparedSeq:
    """Cached :func:`prepare_seq`, keyed on the placed ``obs``."""
    skey = (S, int(length), int(lane_T), bool(first), bool(onehot),
            None if prev_sym is None else int(prev_sym), tuple(obs.shape), str(obs.dtype))
    return cached_build("seq", (obs,), skey, lambda: prepare_seq(
        S, obs, int(length), lane_T=lane_T, first=first, prev_sym=prev_sym, onehot=onehot))
