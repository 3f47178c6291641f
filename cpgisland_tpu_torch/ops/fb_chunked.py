"""Counterpart of ``cpgisland_tpu/ops/fb_pallas.py``'s chunked one-hot E-step.

One EM iteration's sufficient statistics for a batch of independent
chunks: the onehot branch of ``batch_stats_pallas`` with ``fused=True``
(the shipped default), together with ``_batch_lane_setup``,
``_assemble_reduced_stats`` and ``_gamma0_full``.  One chunk per lane;
each lane starts from pi and ends free.  Two kernels carry the
iteration: B4 (forward and self-normalized backward chains,
``fb_onehot.oh_fwdbwd``) and B5 (z-normalized counts,
``fb_onehot.oh_seq_stats``); the rest is small tensor code on the same
device.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_onehot
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


def batch_stats(params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                prepared=None) -> SuffStats:
    """Batch-summed SuffStats of the chunks [N, T] (uint8, padded) with
    true ``lengths`` [N], on the chunks' device.  ``prepared``: the
    symbol-only prep of the same batch (``ops.prepared.prepare_chunked``),
    built once per fit; built here otherwise."""
    K, S = params.n_states, params.n_symbols
    N, T = chunks.shape
    if N == 0:
        # No chunks (compat mode drops a file shorter than one chunk): zero
        # counts, so the M-step keeps the model.
        z = lambda *shape: torch.zeros(shape, dtype=_F32, device=chunks.device)
        return SuffStats(init=z(K), trans=z(K, K), emit=z(K, S), loglik=z(),
                         n_seqs=torch.zeros((), dtype=torch.int32, device=chunks.device))
    if prepared is None:
        prepared = prepare_chunked(S, chunks, lengths, t_tile=DEFAULT_T_TILE)
    elif (prepared.S, prepared.N, prepared.T) != (S, N, T):
        raise ValueError(
            f"prepared streams were built for S={prepared.S}, a {prepared.N} x "
            f"{prepared.T} batch; this call has S={S}, {N} x {T}"
        )
    A, a0_raw, beta0, valid0 = _batch_lane_setup(params, prepared)
    lens2 = prepared.lens2
    al2, b2, esym2 = fb_onehot.run_fb_kernels_onehot(
        params, prepared.sel2, 0, lens2, a0_raw, beta0, T,
        pair_esym=(prepared.pair2, prepared.esym2, prepared.pairn2),
    )
    # Z-normalized stats over the fused streams: zero enters and an all-zero
    # pair0 mask say every lane is an independent record with no incoming
    # t == 0 pair.
    gt = _groups(params)
    NL = al2.shape[2]
    zeros = lambda rows: torch.zeros((rows, NL), dtype=_F32, device=al2.device)
    macc, emit_red, ll = fb_onehot.run_seq_stats_onehot(
        params, al2, b2, prepared.pair2, lens2, gt, zeros(GROUP), zeros(K), zeros(1),
        prepared.Tt,
    )
    trans, emit, loglik = _assemble_reduced_stats(params, A, gt, macc, emit_red, ll)
    init_l = torch.where(valid0[None, :], _gamma0_full(al2, b2, gt, esym2, K), 0.0)
    return SuffStats(
        init=torch.sum(init_l, dim=1),
        trans=trans,
        emit=emit,
        loglik=loglik,
        n_seqs=torch.sum(valid0.to(torch.int32)),
    )
