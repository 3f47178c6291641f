"""CpG island calling from a decoded state path (host NumPy).

Counterpart of ``cpgisland_tpu/ops/islands.py``: the reference's per-chunk
state machine (CpGIslandFinder.java:262-339) as vectorized run accounting.

- ``compat=True`` reproduces the reference's quirks: an island still open at
  the end of the path is never emitted; ``atC`` is not cleared when an island
  opens on a non-C state, so a C ending the previous island can add one CpG
  to the next; no minimum-length filter.
- ``compat=False`` (clean): islands open at the end are emitted, CpG counts
  are within-island C->G adjacencies, and ``min_len`` applies if given.

Records are (beg, end, length, gc_content, oe_ratio) with 1-based inclusive
coordinates beg + chunk*chunk_size + 1 and the filters GC > 0.5 and
observed/expected CpG > 0.6 (java:285-288).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from cpgisland_tpu_torch.utils.chunking import DECODE_CHUNK

# State ids: 0..3 = A+C+G+T+ (island), 4..7 = A-C-G-T- (background).
N_ISLAND_STATES = 4
C_STATE = 1
G_STATE = 2


@dataclass(frozen=True)
class IslandCalls:
    """Columnar island-call records (1-based inclusive global coordinates)."""

    beg: np.ndarray  # int64 [n]
    end: np.ndarray  # int64 [n]
    length: np.ndarray  # int64 [n]
    gc_content: np.ndarray  # float64 [n]
    oe_ratio: np.ndarray  # float64 [n]
    # Optional record (chromosome) names, one per call (clean multi-record).
    names: Optional[np.ndarray] = None  # object [n]

    def __len__(self) -> int:
        return int(self.beg.shape[0])

    def with_names(self, name: str) -> "IslandCalls":
        return replace(self, names=np.full(len(self), name, dtype=object))

    def format_lines(self) -> str:
        """Reference output format '%d %d %d %f %f\\n' (java:287-288), with a
        record-name column prefixed when names are present."""
        if self.names is None:
            return "".join(
                "%d %d %d %f %f\n" % rec
                for rec in zip(self.beg, self.end, self.length, self.gc_content, self.oe_ratio)
            )
        return "".join(
            "%s %d %d %d %f %f\n" % rec
            for rec in zip(
                self.names, self.beg, self.end, self.length, self.gc_content, self.oe_ratio
            )
        )

    @staticmethod
    def concatenate(parts: list["IslandCalls"]) -> "IslandCalls":
        if not parts:
            return _empty_calls()
        names = None
        if any(p.names is not None for p in parts):
            names = np.concatenate(
                [
                    p.names if p.names is not None else np.full(len(p), "", dtype=object)
                    for p in parts
                ]
            )
        return IslandCalls(
            beg=np.concatenate([p.beg for p in parts]),
            end=np.concatenate([p.end for p in parts]),
            length=np.concatenate([p.length for p in parts]),
            gc_content=np.concatenate([p.gc_content for p in parts]),
            oe_ratio=np.concatenate([p.oe_ratio for p in parts]),
            names=names,
        )


def _empty_calls() -> IslandCalls:
    z = np.zeros(0, dtype=np.int64)
    f = np.zeros(0, dtype=np.float64)
    return IslandCalls(z, z, z, f, f)


def counts_to_gc_oe(c_count, g_count, cg_count, length):
    """(gc_content, oe_ratio) in f64 from per-run int64 counts — the
    reference's two formulas (CpGIslandFinder.java:281-283)."""
    gc = (c_count + g_count) / length
    both = (c_count > 0) & (g_count > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        oe = np.where(
            both,
            cg_count.astype(np.float64) * length
            / np.where(both, c_count.astype(np.float64) * g_count, 1.0),
            0.0,
        )
    return gc, oe


def _runs_to_calls(
    in_mask: np.ndarray,
    opening: np.ndarray,
    is_c: np.ndarray,
    is_g: np.ndarray,
    cg_event: np.ndarray,
    *,
    drop_open_at_end: bool,
    min_len: Optional[int],
    gc_threshold: float,
    oe_threshold: float,
    offset: int,
) -> IslandCalls:
    """Masks -> filtered (beg, end, len, gc, oe) records."""
    T = in_mask.shape[0]
    starts = np.flatnonzero(opening)
    if starts.size == 0:
        return _empty_calls()
    next_in = np.empty(T, dtype=bool)
    next_in[-1] = False
    next_in[:-1] = in_mask[1:]
    last = np.flatnonzero(in_mask & ~next_in)  # last in-island index per run

    if drop_open_at_end:
        # Reference quirk: a run reaching the end of the path never closes.
        open_at_end = last == T - 1
        starts, last = starts[~open_at_end], last[~open_at_end]
        if starts.size == 0:
            return _empty_calls()

    def run_sums(events: np.ndarray) -> np.ndarray:
        cum = np.concatenate([[0], np.cumsum(events, dtype=np.int64)])
        return cum[last + 1] - cum[starts]

    c_count = run_sums(is_c)
    g_count = run_sums(is_g)
    cg_count = run_sums(cg_event)
    length = last - starts + 1
    gc, oe = counts_to_gc_oe(c_count, g_count, cg_count, length)
    keep = (gc > gc_threshold) & (oe > oe_threshold)
    if min_len is not None:
        keep &= length > min_len
    return IslandCalls(
        beg=(starts[keep] + offset + 1).astype(np.int64),
        end=(last[keep] + offset + 1).astype(np.int64),
        length=length[keep].astype(np.int64),
        gc_content=gc[keep].astype(np.float64),
        oe_ratio=oe[keep].astype(np.float64),
    )


def call_islands(
    path: np.ndarray,
    *,
    chunk: int = 0,
    chunk_size: int = DECODE_CHUNK,
    compat: bool = True,
    min_len: Optional[int] = None,
    gc_threshold: float = 0.5,
    oe_threshold: float = 0.6,
) -> IslandCalls:
    """Call CpG islands from a state path (modes in the module docstring)."""
    path = np.asarray(path)
    T = path.shape[0]
    if T == 0:
        return _empty_calls()

    in_mask = path < N_ISLAND_STATES
    prev_in = np.empty(T, dtype=bool)
    prev_in[0] = False
    prev_in[1:] = in_mask[:-1]
    opening = in_mask & ~prev_in
    continuing = in_mask & prev_in
    is_c = in_mask & (path == C_STATE)
    is_g = in_mask & (path == G_STATE)

    if compat:
        # The machine's atC carry: (re)assigned at continuing positions (to
        # path==C) and at openings on a C (to True), held elsewhere —
        # forward-fill the latest assignment.
        definitive = continuing | (opening & is_c)
        idx = np.arange(T)
        last_def = np.maximum.accumulate(np.where(definitive, idx, -1))
        last_def_before = np.empty(T, dtype=np.int64)
        last_def_before[0] = -1
        last_def_before[1:] = last_def[:-1]
        atc_before = (last_def_before >= 0) & (path[np.maximum(last_def_before, 0)] == C_STATE)
        # CpG counted only in the continuing branch (java:299-305).
        cg_event = continuing & (path == G_STATE) & atc_before
    else:
        cg_event = continuing & is_g & np.concatenate([[False], is_c[:-1]])

    return _runs_to_calls(
        in_mask, opening, is_c, is_g, cg_event,
        drop_open_at_end=compat,
        min_len=None if compat else min_len,
        gc_threshold=gc_threshold,
        oe_threshold=oe_threshold,
        offset=chunk * chunk_size,
    )


def call_islands_obs(
    path: np.ndarray,
    obs: np.ndarray,
    *,
    island_states,
    min_len: Optional[int] = None,
    gc_threshold: float = 0.5,
    oe_threshold: float = 0.6,
    offset: int = 0,
) -> IslandCalls:
    """Island calling for any set of island states (clean semantics only).

    :func:`call_islands` reads the base out of the state id (the
    reference's A+..T- labeling); models whose states do not encode bases
    need membership from the PATH and composition from the OBSERVATIONS: a
    position is in an island iff path[t] is in ``island_states``, and the
    C/G/CpG counts come from obs[t] (symbol ids 0..3 = acgt).  Same
    records and thresholds; coordinates are 1-based plus ``offset``."""
    path = np.asarray(path)
    obs = np.asarray(obs)
    if path.shape != obs.shape:
        raise ValueError(f"path {path.shape} and obs {obs.shape} differ")
    if path.shape[0] == 0:
        return _empty_calls()
    in_mask = np.isin(path, np.asarray(list(island_states)))
    prev_in = np.concatenate([[False], in_mask[:-1]])
    opening = in_mask & ~prev_in
    is_c = in_mask & (obs == 1)
    is_g = in_mask & (obs == 2)
    cg_event = in_mask & prev_in & (obs == 2) & np.concatenate([[False], obs[:-1] == 1])
    return _runs_to_calls(
        in_mask, opening, is_c, is_g, cg_event,
        drop_open_at_end=False,
        min_len=min_len,
        gc_threshold=gc_threshold,
        oe_threshold=oe_threshold,
        offset=offset,
    )
