"""Counterpart of ``cpgisland_tpu/ops/fb_pallas.py``'s chunked E-step.

One EM iteration's sufficient statistics for a batch of independent
chunks: ``batch_stats_pallas``, together with ``_batch_lane_setup``,
``_assemble_reduced_stats`` and ``_gamma0_full``.  One chunk per lane; each
lane starts from pi and ends free.  The reduced engine ("onehot") runs, on
the fused arm (``fused=True``, the shipped default), two kernels: B4
(forward and self-normalized backward chains, ``fb_onehot.oh_fwdbwd``) and
B5 (z-normalized counts, ``fb_onehot.oh_seq_stats``); on the split arm
(``fused=False``) three: B9 (forward), B10 (cs-scaled backward) and B12
(counts degree 1 in those betas, ``fb_onehot.oh_stats``).  A reduced model
whose alphabet is not a power of two always takes the split chains, its
streams scattered to dense for B20.  The dense engine ("pallas", any K <=
8 model) runs three: B16 (forward), B18 (backward) and B20 (counts) of
``ops.fb_pallas``.  The rest is small tensor code on the same device.
``batch_stats_stacked`` runs M reduced members of one K over one batch
through the stacked kernels B24 and B25, or B22 and B23 with B12 per
member on the split arm.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_onehot, fb_pallas
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.ops.prepared import PreparedChunked, prepare_chunked
from cpgisland_tpu_torch.ops.viterbi_onehot import GROUP, _groups

# Steps per t-tile of the chunked layout (the JAX package's default, kept
# so both lay a batch out on the same geometry); B5 reduces in segments of
# this many steps.
DEFAULT_T_TILE = 512

_F32 = torch.float32


def _batch_lane_setup(params: HmmParams, prep: PreparedChunked):
    """The params-dependent half of the lane layout: (A, a0_raw [K, NL] —
    pi times the first emission, unnormalized, 1/K on empty lanes —, beta0
    [K, NL] ones (chunks end free), valid0 [NL])."""
    K = params.n_states
    A, B, pi = params.A.to(_F32), params.B.to(_F32), params.pi.to(_F32)
    valid0 = prep.lens2[0] > 0
    NL = prep.steps2.shape[1]
    B0 = B[:, prep.steps2[0].long()]  # [K, NL]; steps2 is clamped to [0, S)
    a0_raw = torch.where(valid0[None, :], pi[:, None] * B0,
                         torch.full((K, NL), 1.0 / K, dtype=_F32, device=B.device))
    beta0 = torch.ones((K, NL), dtype=_F32, device=B.device)
    return A, a0_raw, beta0, valid0


def _assemble_reduced_stats(params: HmmParams, A, gt, macc, emit_red, ll):
    """(trans, emit, loglik) from B5's per-lane outputs."""
    K, S = params.n_states, params.n_symbols
    trans = A * torch.sum(macc, dim=1).reshape(K, K)
    iS = torch.arange(S, device=A.device)
    emit = torch.zeros((K, S), dtype=_F32, device=A.device)
    emit = emit.index_put((gt[:, 0], iS), torch.sum(emit_red[0::2], dim=1), accumulate=True)
    emit = emit.index_put((gt[:, 1], iS), torch.sum(emit_red[1::2], dim=1), accumulate=True)
    return trans, emit, torch.sum(ll)


def _gamma0_full(al2, b2, gt, esym2, K):
    """Dense gamma at within-lane position 0 from the reduced streams."""
    g02 = al2[0] * b2[0]  # [GROUP, NL]
    gamma02 = g02 / torch.clamp_min(torch.sum(g02, dim=0, keepdim=True), 1e-30)
    return fb_onehot.scatter_streams(gamma02[None], gt, esym2[0:1], K)[0]


def _dense_suffstats(params: HmmParams, A, B, alphas, betas, prep: PreparedChunked,
                     valid0) -> SuffStats:
    """SuffStats from dense cs-scaled [Tp, K, NL] streams: B20, then trans
    = A * sum(macc), emit = sum(emit).reshape(S, K).T, init = gamma_0 on
    the valid lanes."""
    K, S = params.n_states, params.n_symbols
    macc, emitf, ll = fb_pallas._run_stats_kernel(B, alphas, betas, prep.steps2, prep.lens2,
                                                  prep.Tt)
    g0raw = alphas[0] * betas[0]  # [K, NL]
    gamma0 = g0raw / torch.clamp_min(fb_pallas.seq_sum(g0raw, 0), 1e-30)
    return SuffStats(
        init=torch.sum(torch.where(valid0[None, :], gamma0, 0.0), dim=1),
        trans=A * torch.sum(macc, dim=1).reshape(K, K),
        emit=torch.sum(emitf, dim=1).reshape(S, K).T,
        loglik=torch.sum(ll),
        n_seqs=torch.sum(valid0.to(torch.int32)),
    )


def _dense_batch_stats(params: HmmParams, prep: PreparedChunked, a0_raw, beta0,
                       valid0) -> SuffStats:
    """The dense branch of ``batch_stats_pallas``: B16 -> B18 -> B20."""
    A, B, _ = fb_pallas.tables(params)
    alphas, _, betas = fb_pallas._run_fb_kernels(A, B, prep.steps2, prep.lens2, a0_raw,
                                                 beta0, prep.T)
    return _dense_suffstats(params, A, B, alphas, betas, prep, valid0)


def batch_stats(params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                prepared=None, engine: str = "onehot", fused: bool = True) -> SuffStats:
    """Batch-summed SuffStats of the chunks [N, T] (uint8, padded) with
    true ``lengths`` [N], on the chunks' device, through the reduced
    ("onehot") or the dense ("pallas") kernels.  ``prepared``: the
    symbol-only prep of the same batch (``ops.prepared.prepare_chunked``
    for the same engine), built once per fit; built here otherwise.
    ``fused`` (reduced engine, power-of-two alphabet): B4 + B5, else the
    split arm B9 + B10 + B12; the dense engine ignores it."""
    if engine not in ("onehot", "pallas"):
        raise ValueError(f"batch_stats engine must be onehot|pallas, got {engine!r}")
    onehot = engine == "onehot"
    K, S = params.n_states, params.n_symbols
    N, T = chunks.shape
    if N == 0:
        # No chunks (compat mode drops a file shorter than one chunk): zero
        # counts, so the M-step keeps the model.
        z = lambda *shape: torch.zeros(shape, dtype=_F32, device=chunks.device)
        return SuffStats(init=z(K), trans=z(K, K), emit=z(K, S), loglik=z(),
                         n_seqs=torch.zeros((), dtype=torch.int32, device=chunks.device))
    if prepared is None:
        prepared = prepare_chunked(S, chunks, lengths, t_tile=DEFAULT_T_TILE, onehot=onehot)
    elif (prepared.S, prepared.N, prepared.T, prepared.onehot) != (S, N, T, onehot):
        raise ValueError(
            f"prepared streams were built for S={prepared.S}, a {prepared.N} x "
            f"{prepared.T} batch, onehot={prepared.onehot}; this call has S={S}, "
            f"{N} x {T}, onehot={onehot}"
        )
    A, a0_raw, beta0, valid0 = _batch_lane_setup(params, prepared)
    if not onehot:
        return _dense_batch_stats(params, prepared, a0_raw, beta0, valid0)
    lens2 = prepared.lens2
    can_znorm = S & (S - 1) == 0
    use_fused = fused and can_znorm
    al2, b2, esym2 = fb_onehot.run_fb_kernels_onehot(
        params, prepared.sel2, 0, lens2, a0_raw, beta0, T,
        pair_esym=(prepared.pair2, prepared.esym2, prepared.pairn2), fused=use_fused,
    )
    gt = _groups(params)
    if not can_znorm:
        # The split streams scattered to dense (exact: out-of-group entries
        # are zeros wherever they are multiplied in) for B20.
        _, B, _ = fb_pallas.tables(params)
        scatter = lambda x: fb_onehot.scatter_streams(x, gt, esym2, K)
        return _dense_suffstats(params, A, B, scatter(al2), scatter(b2), prepared, valid0)
    if use_fused:
        # Z-normalized stats over the fused streams: zero enters and an
        # all-zero pair0 mask say every lane is an independent record with
        # no incoming t == 0 pair.
        NL = al2.shape[2]
        zeros = lambda rows: torch.zeros((rows, NL), dtype=_F32, device=al2.device)
        counts = fb_onehot.run_seq_stats_onehot(
            params, al2, b2, prepared.pair2, lens2, gt, zeros(GROUP), zeros(K), zeros(1),
            prepared.Tt,
        )
    else:
        counts = fb_onehot.run_stats_onehot(
            params, al2, b2, prepared.pair2, lens2, gt, prepared.Tt,
            betas_scale=fb_onehot.beta_scale_of(fused=use_fused),
        )
    return _reduced_suffstats(params, A, gt, al2, b2, esym2, counts, valid0)


def _reduced_suffstats(params: HmmParams, A, gt, al2, b2, esym2, counts, valid0) -> SuffStats:
    """One member's SuffStats from its reduced streams and B5's (or B25's)
    per-lane counts."""
    trans, emit, loglik = _assemble_reduced_stats(params, A, gt, *counts)
    init_l = torch.where(valid0[None, :], _gamma0_full(al2, b2, gt, esym2, params.n_states), 0.0)
    return SuffStats(
        init=torch.sum(init_l, dim=1),
        trans=trans,
        emit=emit,
        loglik=loglik,
        n_seqs=torch.sum(valid0.to(torch.int32)),
    )


def batch_stats_stacked(params_list, chunks: torch.Tensor, lengths: torch.Tensor,
                        prepared=None, fused: bool = True) -> tuple:
    """Per-member SuffStats of M reduced members of one K over ONE chunk
    batch — the counterpart of the JAX package's
    ``batch_stats_pallas_stacked``.  ``fused``: one launch of B24 (every
    member's chains) and one of B25 (every member's counts); else the split
    arm, one launch of B22 and one of B23 (every member's chains) and B12
    per member.  Member m's stats equal ``batch_stats(params_list[m], ...,
    engine="onehot", fused=fused)`` bit for bit.  ``prepared``: the batch's
    onehot chunked prep, shared by every member (built here otherwise)."""
    S = fb_onehot.check_stacked_members(params_list)
    N, T = chunks.shape
    if prepared is None:
        prepared = prepare_chunked(S, chunks, lengths, t_tile=DEFAULT_T_TILE, onehot=True)
    elif (prepared.S, prepared.N, prepared.T, prepared.onehot) != (S, N, T, True):
        raise ValueError("prepared streams were not built for this batch on the onehot engine")
    setups = [_batch_lane_setup(p, prepared) for p in params_list]
    lens2 = prepared.lens2
    al, be, esym2 = fb_onehot.run_fb_kernels_onehot_stacked(
        params_list, lens2, [s[1] for s in setups], [s[2] for s in setups], T,
        pair_esym=(prepared.pair2, prepared.esym2, prepared.pairn2), fused=fused,
    )
    if fused:
        M, NL = len(params_list), al.shape[3]
        K = params_list[0].n_states
        zeros = lambda *shape: torch.zeros(shape, dtype=_F32, device=al.device)
        counts = fb_onehot.run_seq_stats_onehot_stacked(
            params_list, al, be, prepared.pair2, lens2, zeros(M, GROUP, NL), zeros(M, K, NL),
            zeros(1, NL), prepared.Tt,
        )
    else:
        # The split arm's cs-scaled betas pair with B12, one launch per
        # member, each over its own contiguous slice.
        counts = [fb_onehot.run_stats_onehot(p, al[m], be[m], prepared.pair2, lens2,
                                             _groups(p), prepared.Tt,
                                             betas_scale=fb_onehot.beta_scale_of(fused=False))
                  for m, p in enumerate(params_list)]
    return tuple(
        _reduced_suffstats(p, A, _groups(p), al[m], be[m], esym2, counts[m], valid0)
        for m, (p, (A, _, _, valid0)) in enumerate(zip(params_list, setups))
    )
