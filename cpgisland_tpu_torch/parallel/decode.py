"""Whole-record Viterbi decode on one device.

Counterpart of ``cpgisland_tpu/parallel/decode.py``, for one device (the JAX
package shards a record over a mesh; here the mesh has one member, so the
cross-device stitching is the identity and no collective runs).  Engine
resolution keeps the JAX package's rules, without its fault breaker.
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
    """Last real symbol strictly before obs[lo] (host scan; O(PAD run))."""
    i = lo - 1
    while i >= 0 and int(obs[i]) >= n_symbols:
        i -= 1
    return int(obs[i]) if i >= 0 else 0


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


def _decode_body(params: HmmParams, arr: torch.Tensor, block_size: int, engine: str,
                 prev0: torch.Tensor, *, continuation: bool = False,
                 v_entry: Optional[torch.Tensor] = None, exit_anchor: int = -1):
    """The JAX package's per-device decode body (``_shard_body``) with one
    device, over placed symbols -> (path [L], prev_exit []).

    ``continuation=False`` is the standalone decode: v0 is the init vector
    and ``v_entry`` is ignored.  ``continuation=True`` decodes a later span
    of a longer record: every position is a real step and ``v_entry`` is
    the normalized [K] score vector at the previous span's last position.
    ``exit_anchor`` >= 0 pins the final state (the next span's entry
    state); < 0 takes the local argmax.  ``prev_exit`` is the state just
    before the first step."""
    products, backpointers, backtrace = get_passes(engine)
    K = params.n_states
    if continuation:
        v0 = v_entry
    else:
        _, emit_ext = _step_tables(params)
        v0 = params.log_pi + emit_ext[torch.clamp_max(arr[0].long(), params.n_symbols)]
    steps2 = _steps2(params, arr, block_size, continuation)

    incl, _, _ = products(params, steps2, prev0)
    # Forward stitch over one device: the prefix of earlier devices is the
    # identity, so the entering vector is the normalized init vector.
    my_prefix = _identity_logmat(K, arr.device)
    v_dev = nrm_maxplus_vec(torch.amax(v0[:, None] + my_prefix, dim=0))
    v_enter = _enter_vectors(v_dev, incl)
    delta_blocks, F, bps = backpointers(params, v_enter, steps2, prev0)

    # Backward stitch: the exit state is the anchor, else the local argmax.
    Gsuf = _suffix_compositions(F)
    if exit_anchor >= 0:
        s_final = torch.tensor(exit_anchor, dtype=torch.int32, device=arr.device)
    else:
        s_final = torch.argmax(delta_blocks[-1]).to(torch.int32)
    block_exits = torch.cat([Gsuf[1:, :][:, s_final.long()], s_final[None]])
    return backtrace(bps, block_exits), Gsuf[0][s_final.long()]


def _span_total(params: HmmParams, arr: torch.Tensor, block_size: int, engine: str,
                prev0: torch.Tensor, continuation: bool) -> torch.Tensor:
    """Products-only sweep (the JAX ``_span_total_body`` with one device):
    the span's normalized [K, K] max-plus transfer operator."""
    products, _, _ = get_passes(engine)
    _, _, total = products(params, _steps2(params, arr, block_size, continuation), prev0)
    # The cross-device scan over one total.  The identity's off-diagonal
    # LOG_ZERO is finite, so the product lifts entries below LOG_ZERO (two
    # impossible steps) and is kept to match the scan bit for bit.
    return nrm_maxplus(maxplus_matmul(_identity_logmat(params.n_states, arr.device), total))


def _place(params: HmmParams, piece: np.ndarray, n: int) -> torch.Tensor:
    """Upload symbols (as they come, uint8 for FASTA records) and pad them
    on the device with PAD to ``n`` symbols."""
    arr = chunking.upload(piece, params.device)
    if n > arr.shape[0]:
        arr = torch.cat([arr, arr.new_full((n - arr.shape[0],), params.n_symbols)])
    return arr


def _padded(n: int, block_size: int) -> int:
    return -(-n // block_size) * block_size


def viterbi_sharded(
    params: HmmParams,
    obs,
    *,
    block_size: int = DEFAULT_BLOCK,
    engine: str = "auto",
    return_device: bool = False,
):
    """Decode one whole record on the params' device; returns the [T] int32
    path on the host, or as a tensor on the device with ``return_device``
    (for the device island caller).  The record pads with the PAD sentinel
    to a multiple of ``block_size`` (PAD steps are identity, so the result
    is exact).  The dense engines ignore ``prev0``."""
    obs = np.asarray(obs)
    T = obs.shape[0]
    eng = _engine_for_record(resolve_engine(engine, params), obs, params)
    S = params.n_symbols
    prev0 = torch.tensor(int(obs[0]) if T and int(obs[0]) < S else 0, dtype=torch.int32,
                         device=params.device)
    arr = _place(params, obs, _padded(T, block_size))
    path = _decode_body(params, arr, block_size, eng, prev0)[0][:T]
    return path if return_device else path.cpu().numpy()


def viterbi_sharded_spans(
    params: HmmParams,
    obs,
    *,
    span: int,
    block_size: int = DEFAULT_BLOCK,
    engine: str = "auto",
    return_device: bool = False,
) -> list:
    """EXACT decode of a record longer than one pass's device-memory budget.

    The record runs in ``span``-symbol pieces with the cross-span stitching
    carried by the messages of the one-device body: sweep A composes each
    span's [K, K] max-plus transfer operator (products only) on the host
    into every span's exact entering score vector; sweep B decodes the spans
    in reverse, each anchored at the next span's entry state, which its
    ``prev_exit`` threads back.  No DP restarts anywhere, so the result
    equals a one-shot decode of the whole record.  Peak device memory is
    one span's decode plus the record's symbols (uint8); the extra work is
    the products sweep over every span but the last.  Returns the per-span
    paths in forward order (device tensors with ``return_device``).  A
    record of at most ``span`` symbols delegates to :func:`viterbi_sharded`.
    """
    obs = np.asarray(obs)
    eng = _engine_for_record(resolve_engine(engine, params), obs, params)
    T = obs.shape[0]
    if T <= span:
        return [viterbi_sharded(params, obs, block_size=block_size, engine=eng,
                                return_device=return_device)]
    S = params.n_symbols
    dev = params.device
    n_spans = -(-T // span)

    def place(s: int) -> torch.Tensor:
        # The ragged tail pads to the full span (identity PAD steps), so
        # every span has one shape.
        return _place(params, obs[s * span : (s + 1) * span], _padded(span, block_size))

    def span_prev0(s: int) -> torch.Tensor:
        """The symbol before span s (the onehot engine's entry group; the
        dense engines ignore it).  Span 0's entry is its own position 0."""
        lo = s * span
        sym = (_prev_real_symbol(obs, lo, S) if lo
               else (int(obs[0]) if int(obs[0]) < S else 0))
        return torch.tensor(sym, dtype=torch.int32, device=dev)

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
        total = _span_total(params, placed[s], block_size, eng, span_prev0(s),
                            s > 0).cpu().numpy()
        v = (enters[-1][:, None] + total).max(axis=0)
        enters.append((v - v.max()).astype(np.float32))

    # Sweep B: decode each span anchored at the next span's entry state.
    paths: list = [None] * n_spans
    anchor = -1  # the last span: the local argmax
    for s in reversed(range(n_spans)):
        arr = placed.pop(s) if s in placed else place(s)
        path, prev_exit = _decode_body(
            params, arr, block_size, eng, span_prev0(s),
            continuation=s > 0, v_entry=torch.from_numpy(enters[s]).to(dev),
            exit_anchor=anchor)
        del arr
        anchor = int(prev_exit)
        path = path[: min(span, T - s * span)]
        paths[s] = path if return_device else path.cpu().numpy()
    return paths
