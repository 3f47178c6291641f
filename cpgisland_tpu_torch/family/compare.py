"""Multi-model posterior comparison: N family members over one record.

Counterpart of ``cpgisland_tpu/family/compare.py``.  Per member: the record
log-likelihood, the log-odds against a baseline member, the posterior
island-confidence track and the member's island calls; and a per-position
WINNER track (the member most confident of an island at each position),
emitted in the reference island format.

Each member's confidence and path come from the record unit the posterior
pipeline runs (``pipeline._posterior_record_unit``), or, for same-order
members on the reduced engine, from one stacked dispatch that equals it bit
for bit (``family.stacked``); the comparison adds the scoring pass
(``ops.forward_backward.sequence_loglik``, or one stacked scoring launch
set for such a group, equal to it bit for bit) and host-side track
algebra.
Each order's stream is encoded, padded to a power of two (floor 16 Ki) and
uploaded ONCE, and the scoring pass and every member of that order share
it.  Order-2 members read the pair recode (``codec.recode_pairs``), which is
position-aligned with the base stream, so every track lives on base-stream
coordinates.  Null members (no island states) only score: their confidence
is zero by construction and no posterior runs for them.

Members of one order score the same number of emissions, so their log-odds
compare directly; across orders the structural offset remains (compare pair
members against ``null16``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from cpgisland_tpu_torch.ops import islands as islands_mod
from cpgisland_tpu_torch.ops.islands import IslandCalls
from cpgisland_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh

#: A winner-track position must beat this island confidence to be claimed
#: by a member; everything else falls back to the background (-1).
DEFAULT_WINNER_THRESHOLD = 0.5


@dataclasses.dataclass
class MemberResult:
    """One member's result over one record (base-stream coordinates)."""

    name: str
    loglik: float
    log_odds: float  # loglik - baseline member's loglik (natural log)
    conf: np.ndarray  # [T] float32 P(position in island | record)
    calls: IslandCalls  # from the member's own MPM path


@dataclasses.dataclass
class RecordComparison:
    record: str
    n_symbols: int
    baseline: str
    members: list  # [MemberResult] in input member order
    winner: np.ndarray  # [T] int8 member index, -1 = background / no island
    winner_calls: IslandCalls  # names = winning member names

    def member(self, name: str) -> MemberResult:
        for m in self.members:
            if m.name == name:
                return m
        raise KeyError(name)


def resolve_baseline(members, baseline: Optional[str]) -> int:
    """Index of the log-odds baseline member: an explicit name, else the
    single null member when exactly one exists, else the first member."""
    if baseline is not None:
        for i, m in enumerate(members):
            if m.name == baseline:
                return i
        raise ValueError(f"baseline {baseline!r} is not one of {[m.name for m in members]}")
    nulls = [i for i, m in enumerate(members) if m.is_null]
    return nulls[0] if len(nulls) == 1 else 0


def winner_track(confs: np.ndarray, threshold: float = DEFAULT_WINNER_THRESHOLD) -> np.ndarray:
    """[N, T] member confidences -> [T] int8 winner index: the member with
    the highest confidence at t when it exceeds ``threshold``, else -1
    (background).  Ties go to the lower member index."""
    if confs.shape[0] > 127:
        raise ValueError("winner track is int8: at most 127 members")
    if not threshold >= 0.0:
        # A negative threshold would claim every position for the argmax
        # member, null members' zero columns included, which winner_calls
        # never emits.
        raise ValueError(
            f"winner threshold must be >= 0 (confidences are probabilities), got {threshold}"
        )
    best = np.argmax(confs, axis=0).astype(np.int8)
    return np.where(confs[best, np.arange(confs.shape[1])] > threshold, best, np.int8(-1))


def _sorted_calls(calls: IslandCalls) -> IslandCalls:
    order = np.argsort(calls.beg, kind="stable")
    return IslandCalls(
        beg=calls.beg[order], end=calls.end[order], length=calls.length[order],
        gc_content=calls.gc_content[order], oe_ratio=calls.oe_ratio[order],
        names=None if calls.names is None else calls.names[order],
    )


def winner_calls(members, winner: np.ndarray, symbols: np.ndarray,
                 min_len: Optional[int] = None) -> IslandCalls:
    """The winner track as reference-format island records: runs where
    member m wins become intervals (1-based, base-stream coordinates) with
    GC / obs-exp composition from the BASE observations and the winning
    member's name in the name column, merged and sorted by position."""
    parts = []
    for idx, m in enumerate(members):
        if m.is_null:
            continue  # confidence 0 never exceeds the threshold
        c = islands_mod.call_islands_obs(winner, symbols, island_states=(idx,), min_len=min_len)
        parts.append(c.with_names(m.name))
    return _sorted_calls(IslandCalls.concatenate(parts))


def compare_record(
    members,
    symbols: np.ndarray,
    *,
    record: str = "",
    engine: str = "auto",
    baseline: Optional[str] = None,
    min_len: Optional[int] = None,
    threshold: float = DEFAULT_WINNER_THRESHOLD,
    prev: Optional[int] = None,
    sessions=None,
    supervisor=None,
    stacked: Optional[bool] = None,
    streams_handle=None,
    device="cuda",
    phases: Optional[dict] = None,
) -> RecordComparison:
    """Compare ``members`` over one base-alphabet record (see the module
    docstring) on ``device`` (default "cuda"; the members' params move
    there).  ``engine`` is the request every member's FB engine resolves
    from (``parallel.posterior.resolve_fb_engine``).  ``prev``: the base
    before the record, threaded into order-2 recodes.  ``stacked`` (None
    means True: the JAX package's tuner table is not ported, ROADMAP A14)
    groups same-order members on the reduced engine into one stacked
    dispatch; a failure there raises.  ``phases``: a dict that wall seconds
    per phase ("encode", "score", "posterior", "islands", "winner") are
    added to.  Serving sessions and shared stream handles (ROADMAP A13) and
    the supervisor (A12) are not ported and raise NotImplementedError."""
    # The pipeline imports this package: its modules load at call time.
    from cpgisland_tpu_torch import pipeline
    from cpgisland_tpu_torch.family import stacked as stacked_mod
    from cpgisland_tpu_torch.ops.loglik import sequence_loglik, sequence_loglik_stacked
    from cpgisland_tpu_torch.parallel import posterior as post

    for requested, what in (
        (sessions is not None, "serving sessions (ROADMAP A13)"),
        (streams_handle is not None, "shared prepared-stream handles (ROADMAP A13)"),
        (supervisor is not None, "the resilience supervisor (ROADMAP A12)"),
    ):
        if requested:
            raise NotImplementedError(f"compare_record: {what} not ported yet")
    if not members:
        raise ValueError("compare needs at least one member")
    names = [m.name for m in members]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate member names: {names}")
    stacked = True if stacked is None else bool(stacked)
    phases = {} if phases is None else phases
    dev = pipeline.resolve_device(device)
    # The posteriors split each record over every local card (one entry on
    # the CPU), as the JAX package's default mesh takes every device.
    mesh = make_mesh(axis=SEQ_AXIS, device=dev)
    symbols = np.ascontiguousarray(symbols, dtype=np.uint8)
    T = symbols.shape[0]
    b_idx = resolve_baseline(members, baseline)
    members = [dataclasses.replace(m, params=m.params.to(dev)) for m in members]

    # One stream per ORDER, padded and uploaded once: the scoring pass and
    # every member's posterior of that order read the same device buffer.
    streams: dict = {}
    with pipeline._phase(phases, "encode"):
        for m in members:
            if m.order not in streams:
                st = m.encode(symbols, prev=prev)
                pad = pipeline._round_pow2(max(st.shape[0], 1), floor=1 << 14)
                placed = post.place_record_span(m.params, st, pad_to=pad)
                # A mesh of several entries holds its own copy in shards.
                on_mesh = (placed if mesh.size == 1 else
                           post.place_record_span(m.params, st, pad_to=pad, mesh=mesh))
                streams[m.order] = (st, placed, on_mesh)
    fb_engs = [None if (m.is_null or T == 0) else post.resolve_fb_engine(engine, m.params)
               for m in members]
    groups = stacked_mod.stack_groups(members, fb_engs, enabled=stacked)
    with pipeline._phase(phases, "score"):
        logliks: dict = {}
        for order, idxs in groups.items():
            st, placed, _ = streams[order]
            scores = sequence_loglik_stacked([members[i].params for i in idxs], placed,
                                             st.shape[0])
            logliks.update(zip(idxs, scores))
        for i, m in enumerate(members):
            if i not in logliks:
                st, placed, _ = streams[m.order]
                logliks[i] = sequence_loglik(m.params, placed, st.shape[0])

    confs = np.zeros((len(members), T), np.float32)
    paths: dict = {}
    t0 = time.perf_counter()
    for order, idxs in groups.items():
        st, _, on_mesh = streams[order]
        g_confs, g_paths = stacked_mod.stacked_posterior_records(
            [members[i] for i in idxs], st, placed=on_mesh, mesh=mesh)
        for k, i in enumerate(idxs):
            confs[i] = g_confs[k]
            paths[i] = g_paths[k]
    for i, m in enumerate(members):
        if m.is_null or T == 0 or i in paths:
            continue
        st, _, on_mesh = streams[m.order]
        confs[i], paths[i] = pipeline._posterior_record_unit(
            m.params, st, m.island_states, engine=fb_engs[i], want_path=True, placed=on_mesh,
            mesh=mesh)
    phases["posterior"] = phases.get("posterior", 0.0) + time.perf_counter() - t0

    calls: list = []
    with pipeline._phase(phases, "islands"):
        for i, m in enumerate(members):
            if m.is_null or T == 0:
                calls.append(islands_mod._empty_calls().with_names(m.name))
                continue
            # Membership from the member's own MPM path, composition from the
            # BASE observations (position-aligned for order-2 members too).
            calls.append(islands_mod.call_islands_obs(
                paths[i], symbols, island_states=m.island_states, min_len=min_len,
            ).with_names(m.name))
    with pipeline._phase(phases, "winner"):
        winner = winner_track(confs, threshold) if T else np.zeros(0, np.int8)
        w_calls = winner_calls(members, winner, symbols, min_len=min_len)
    results = [
        MemberResult(name=m.name, loglik=logliks[i], log_odds=logliks[i] - logliks[b_idx],
                     conf=confs[i], calls=calls[i])
        for i, m in enumerate(members)
    ]
    return RecordComparison(record=record, n_symbols=T, baseline=members[b_idx].name,
                            members=results, winner=winner, winner_calls=w_calls)
