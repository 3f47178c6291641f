"""Whole-record Viterbi decode, sequence-parallel over a mesh.

Counterpart of ``cpgisland_tpu/parallel/decode.py``.  A record splits along
time over a mesh's shards (``parallel.mesh``; default one entry on the
params' device); every shard runs the blockwise passes of
``ops.viterbi_parallel`` (B1-B3 on the reduced engine, B13-B15 on the
dense one, the plain "xla" twins otherwise), and the stitching is exact:
the shards' [K, K] max-plus transfer totals gather onto the first device,
where a prefix scan gives every shard its entering score vector, and the
shards' [K] exit -> entry maps gather there too, anchoring every shard's
exit state to the global argmax — the JAX package's two small all-gathers
(``_shard_body``), on a single controller.  A one-entry mesh runs the
same body, where the stitching is the identity.  Engine resolution
keeps the JAX package's rules, without its fault breaker.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import viterbi_pallas
from cpgisland_tpu_torch.ops.viterbi_parallel import (
    DEFAULT_BLOCK,
    _enter_vectors,
    _identity_logmat,
    _step_tables,
    _suffix_compositions,
    get_passes,
    maxplus_matmul,
    nrm_maxplus,
    nrm_maxplus_vec,
)
from cpgisland_tpu_torch.parallel.fb_sharded import shard_params
from cpgisland_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    Mesh,
    check_mesh,
    fetch_sharded_prefix,
    make_mesh,
)
from cpgisland_tpu_torch.utils import chunking


def resolve_engine(engine: str, params: HmmParams) -> str:
    """'auto' picks the reduced one-hot kernels when the model's emission
    structure supports them (the flagship 8-state model does), else the
    dense kernels when the model fits their 3-bit backpointer packing
    (K <= 8), else the plain "xla" twins.  'auto' picks the same names on
    the CPU, where every kernel wrapper runs its plain version.  An explicit
    engine is checked and honoured as named."""
    if engine == "auto":
        if family_partition.reduced_eligible(params):
            return "onehot"
        return "pallas" if viterbi_pallas.supports(params) else "xla"
    if engine not in ("xla", "pallas", "onehot"):
        raise ValueError(f"unknown engine {engine!r}; expected auto|xla|pallas|onehot")
    if engine == "pallas" and not viterbi_pallas.supports(params):
        raise ValueError(f"pallas engine needs n_states <= 8, got {params.n_states}")
    if engine == "onehot" and not family_partition.reduced_eligible(params):
        raise ValueError(
            "onehot engine needs a one-hot emission-support partition with "
            "2 states per symbol"
        )
    return engine


def _engine_for_record(eng: str, obs: np.ndarray, params: HmmParams) -> str:
    """Demote 'onehot' to a dense engine for records outside its exactness
    domain (first position has no real emission: the reduced chain has no
    entry group there) — the dense kernels when the 3-bit packing fits,
    else the "xla" twins."""
    if eng == "onehot" and (obs.shape[0] == 0 or int(obs[0]) >= params.n_symbols):
        return "pallas" if viterbi_pallas.supports(params) else "xla"
    return eng


def _prev_real_symbol(obs: np.ndarray, lo: int, n_symbols: int) -> int:
    """Last real symbol strictly before obs[lo], else 0 (a host scan back
    over the PAD run, in vectorized pieces)."""
    hi = min(lo, obs.shape[0])
    while hi > 0:
        piece = np.asarray(obs[max(0, hi - 65536):hi])
        real = np.flatnonzero(piece < n_symbols)
        if real.size:
            return int(piece[real[-1]])
        hi -= piece.shape[0]
    return 0


def _entry_sym(obs: np.ndarray, pos: int, n_symbols: int) -> int:
    """The symbol before position ``pos`` of a record (the reduced engine's
    entry group; the dense engines ignore it): the last real symbol before
    it, and at position 0 the record's own first symbol (0 for PAD)."""
    if pos == 0:
        return int(obs[0]) if obs.shape[0] and int(obs[0]) < n_symbols else 0
    return _prev_real_symbol(obs, pos, n_symbols)


def _steps2(params: HmmParams, arr: torch.Tensor, block_size: int,
            continuation: bool) -> torch.Tensor:
    """Placed symbols -> the [bk, nb] int32 step stream, every invalid
    symbol folded into PAD.  A record's first span turns position 0 (the
    init, whose emission folds into v0) into an identity step, so "state
    after step k" is the state at position k."""
    steps = torch.clamp_max(arr.to(torch.int32), params.n_symbols)
    if not continuation:
        steps[0] = params.n_symbols
    return steps.reshape(steps.shape[0] // block_size, block_size).T


def _decode(params: HmmParams, shards, block_size: int, engine: str, prev0s, *,
            continuation: bool = False, v_entry: Optional[torch.Tensor] = None,
            exit_anchor: int = -1):
    """The JAX package's ``_shard_body`` over a mesh's shards -> (per-shard
    paths, prev_exit [] on the first device).

    ``prev0s``: each shard's entry symbol (the reduced engine's; the dense
    engines ignore them).  ``continuation=False`` is the standalone decode:
    v0 is the init vector and ``v_entry`` is ignored.
    ``continuation=True`` decodes a later span of a longer record: every
    position is a real step and ``v_entry`` is the normalized [K] score
    vector at the previous span's last position.  ``exit_anchor`` >= 0
    pins the final state (the next span's entry state); < 0 takes the
    argmax.  ``prev_exit`` is the state just before the first step.

    Forward stitch: the shards' normalized [K, K] totals gather onto the
    first device, whose prefix scan gives each shard its entering vector
    (the identity for the first).  Backward stitch: the shards' exit ->
    entry maps and the last shard's exit scores gather there, and each
    shard's exit state composes back from the anchor (or argmax)."""
    products, backpointers, backtrace = get_passes(engine)
    K, S = params.n_states, params.n_symbols
    ps = shard_params(params, shards)
    dev0 = shards[0].device
    steps, incls, totals = [], [], []
    for d, (p, arr) in enumerate(zip(ps, shards)):
        st = _steps2(p, arr, block_size, continuation or d > 0)
        incl, _, total = products(p, st, prev0s[d])
        steps.append(st)
        incls.append(incl)
        totals.append(total.to(dev0, non_blocking=True))
    if continuation:
        v0 = v_entry.to(dev0)
    else:
        _, emit_ext = _step_tables(params)
        v0 = params.log_pi + emit_ext.index_select(
            0, torch.clamp_max(shards[0][:1].long(), S))[0]
    carry = _identity_logmat(K, dev0)
    bps_list, gsufs = [], []
    delta_last = None
    for d, p in enumerate(ps):
        v_shard = nrm_maxplus_vec(torch.amax(v0[:, None] + carry, dim=0))
        if d + 1 < len(ps):
            carry = nrm_maxplus(maxplus_matmul(carry, totals[d]))
        v_enter = _enter_vectors(v_shard.to(shards[d].device, non_blocking=True), incls[d])
        delta_blocks, F, bps = backpointers(p, v_enter, steps[d], prev0s[d])
        gsufs.append(_suffix_compositions(F))
        bps_list.append(bps)
        delta_last = delta_blocks[-1]
    # Exit states stay [1] tensors on the devices (index_select, not a
    # 0-dim index, which would be read on the host).
    ftables = [g[0].to(dev0, non_blocking=True) for g in gsufs]
    if exit_anchor >= 0:
        s_final = torch.full((1,), exit_anchor, dtype=torch.int32, device=dev0)
    else:
        s_final = torch.argmax(delta_last.to(dev0, non_blocking=True)).to(torch.int32)[None]
    exits = [None] * len(shards)
    exits[-1] = s_final
    for d in range(len(shards) - 2, -1, -1):
        exits[d] = ftables[d + 1].index_select(0, exits[d + 1].long())
    paths = []
    for d, (g, bps) in enumerate(zip(gsufs, bps_list)):
        my_exit = exits[d].to(g.device, non_blocking=True)
        block_exits = torch.cat([g[1:, :].index_select(1, my_exit.long())[:, 0], my_exit])
        paths.append(backtrace(bps, block_exits))
    return paths, ftables[0].index_select(0, exits[0].long())[0]


def _span_total(params: HmmParams, shards, block_size: int, engine: str, prev0s,
                continuation: bool) -> torch.Tensor:
    """Products-only sweep over a mesh (the JAX ``_span_total_body``): the
    shards' normalized [K, K] max-plus totals composed in mesh order on the
    first device.  The identity's off-diagonal LOG_ZERO is finite, so the
    first product lifts entries below LOG_ZERO (two impossible steps); it
    is kept to match the JAX scan bit for bit."""
    products, _, _ = get_passes(engine)
    ps = shard_params(params, shards)
    dev0 = shards[0].device
    C = _identity_logmat(params.n_states, dev0)
    for d, (p, arr) in enumerate(zip(ps, shards)):
        _, _, total = products(p, _steps2(p, arr, block_size, continuation or d > 0), prev0s[d])
        C = nrm_maxplus(maxplus_matmul(C, total.to(dev0, non_blocking=True)))
    return C


def _place(params: HmmParams, obs: np.ndarray, lo: int, hi: int, n: int, mesh: Mesh):
    """Upload the record piece ``obs[lo:hi]`` as ``mesh.size`` shards of
    ``n / mesh.size`` symbols each (as they come, uint8 for FASTA records),
    every shard padded with PAD on its device -> (shards, the shards' entry
    symbols as int32 tensors on their devices)."""
    L = n // mesh.size
    shards, prev0s = [], []
    for d, dev in enumerate(mesh.device_list):
        a = min(lo + d * L, hi)
        arr = chunking.upload(obs[a:min(lo + (d + 1) * L, hi)], dev)
        if L > arr.shape[0]:
            arr = torch.cat([arr, arr.new_full((L - arr.shape[0],), params.n_symbols)])
        shards.append(arr)
        prev0s.append(torch.tensor(_entry_sym(obs, a, params.n_symbols),
                                   dtype=torch.int32, device=dev))
    return shards, prev0s


def _padded(n: int, quantum: int) -> int:
    return -(-n // quantum) * quantum


def viterbi_sharded(
    params: HmmParams,
    obs,
    *,
    mesh: Optional[Mesh] = None,
    block_size: int = DEFAULT_BLOCK,
    engine: str = "auto",
    return_device: bool = False,
):
    """Decode one whole record split along time over ``mesh`` (default:
    one entry on the params' device); returns the [T] int32 path on the
    host, or as a tensor on the mesh's first device with
    ``return_device`` (for the device island caller).  The record pads
    with the PAD sentinel to a multiple of D x ``block_size`` (PAD steps
    are identity, so the result is exact).  The dense engines ignore the
    entry symbols."""
    obs = np.asarray(obs)
    T = obs.shape[0]
    mesh = check_mesh(mesh) or make_mesh(axis=SEQ_AXIS, device=params.device)
    eng = _engine_for_record(resolve_engine(engine, params), obs, params)
    shards, prev0s = _place(params, obs, 0, T, _padded(T, mesh.size * block_size), mesh)
    paths, _ = _decode(params, shards, block_size, eng, prev0s)
    return fetch_sharded_prefix(paths, T, return_device)


def viterbi_sharded_spans(
    params: HmmParams,
    obs,
    *,
    span: int,
    mesh: Optional[Mesh] = None,
    block_size: int = DEFAULT_BLOCK,
    engine: str = "auto",
    return_device: bool = False,
) -> list:
    """EXACT decode of a record longer than one pass's device-memory budget.

    The record runs in ``span``-symbol pieces with the cross-span stitching
    carried by the messages of the decode body: sweep A composes each
    span's [K, K] max-plus transfer operator (products only) on the host
    into every span's exact entering score vector; sweep B decodes the spans
    in reverse, each anchored at the next span's entry state, which its
    ``prev_exit`` threads back.  No DP restarts anywhere, so the result
    equals a one-shot decode of the whole record.  Peak device memory is
    one span's decode plus the record's symbols (uint8); the extra work is
    the products sweep over every span but the last.  Returns the per-span
    paths in forward order (device tensors with ``return_device``).  A
    record of at most ``span`` symbols delegates to :func:`viterbi_sharded`.
    Each span splits over ``mesh`` (default: one entry on the params'
    device), its shards stitched as in :func:`viterbi_sharded`.
    """
    obs = np.asarray(obs)
    eng = _engine_for_record(resolve_engine(engine, params), obs, params)
    T = obs.shape[0]
    mesh = check_mesh(mesh) or make_mesh(axis=SEQ_AXIS, device=params.device)
    if T <= span:
        return [viterbi_sharded(params, obs, mesh=mesh, block_size=block_size, engine=eng,
                                return_device=return_device)]
    S = params.n_symbols
    n_spans = -(-T // span)
    n_pad = _padded(span, mesh.size * block_size)

    def place(s: int):
        # The ragged tail pads to the full span (identity PAD steps), so
        # every span has one shape.
        return _place(params, obs, s * span, min((s + 1) * span, T), n_pad, mesh)

    # Each span is placed once, for both sweeps, and freed as sweep B
    # consumes it.
    placed = {}
    # Sweep A: exact entering score vectors, composed on the host in float32
    # (a PAD first symbol contributes no emission).
    v = params.log_pi.cpu().numpy().astype(np.float32)
    if int(obs[0]) < S:
        v = v + params.log_B.cpu().numpy().astype(np.float32)[:, int(obs[0])]
    enters = [v - v.max()]
    for s in range(n_spans - 1):
        placed[s] = place(s)
        total = _span_total(params, placed[s][0], block_size, eng, placed[s][1],
                            s > 0).cpu().numpy()
        v = (enters[-1][:, None] + total).max(axis=0)
        enters.append((v - v.max()).astype(np.float32))

    # Sweep B: decode each span anchored at the next span's entry state.
    paths: list = [None] * n_spans
    anchor = -1  # the last span: the argmax
    for s in reversed(range(n_spans)):
        shards, prev0s = placed.pop(s) if s in placed else place(s)
        parts, prev_exit = _decode(
            params, shards, block_size, eng, prev0s, continuation=s > 0,
            v_entry=torch.from_numpy(enters[s]).to(mesh.first), exit_anchor=anchor)
        del shards
        anchor = int(prev_exit)
        paths[s] = fetch_sharded_prefix(parts, min(span, T - s * span), return_device)
    return paths
