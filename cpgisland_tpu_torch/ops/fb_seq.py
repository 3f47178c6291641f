"""Counterpart of ``cpgisland_tpu/ops/fb_pallas.py``'s whole-sequence half.

Exact forward-backward over ONE long sequence on one device: the sequence
splits into lanes of ``lane_T`` steps; a products kernel gives each lane's
transfer operator; two associative scans over the lanes turn those into
every lane's exact entering-alpha and exiting-beta directions; the chain
kernels then run every lane's forward and backward from those messages,
so the result is the whole-sequence posterior, not a chunk approximation.
``enter_dir`` / ``exit_dir`` carry the same messages across consecutive
spans of a record too long for one pass (``pipeline.posterior_file``).

Two engines, as in the JAX package.  The reduced one ("onehot", one-hot
emission models such as the flagship) runs B7 (``fb_onehot.oh_prod``,
2x2 products) and B4 (``fb_onehot.oh_fwdbwd``); its boundary combine
stays in the 2-component group space.  The dense one ("pallas", any
model with K <= 8) runs B17 (``fb_pallas.fb_prod``, K x K products), B16
and B18 — or B19, which emits the island confidence, when no path is
asked for — with the combine over [NL, K, K].  The reduced engine has
three arms, as in the JAX package.  The fused two-pass arm (the default)
runs B7 and B4.  The split arm (``fused=False``) runs B7, then the chains
in two launches: B9 (``fb_onehot.oh_fwd``) and B10 (``fb_onehot.oh_bwd``,
true Rabiner betas), or B11 (``fb_onehot.oh_bwd_conf``) when only the
confidence is asked for; every consumer here is scale-free in the betas,
so both arms give the same results to rounding.  With ``one_pass`` B8
(``fb_onehot.oh_fwdbwd_mat``) carries both chains as 2x2 matrices from the
identity, so it runs before the boundary messages exist, the lane products
fall out of its epilogue, and one pass over the sequence replaces B7 and
B4; it takes precedence over ``fused``.  The glue spells every
contraction as an explicit sum in a fixed order (sums over K in order, the
one total row-major), so it gives the same float32 bits on the CPU and on
the card.

``seq_stats`` is the whole-sequence E-step (``SeqBackend``,
``Seq2DBackend``): B5 over the reduced streams, or the scale-free
assembly in plain torch over the dense ones.

``seq_posterior_stacked`` runs M reduced members over one record through
the stacked kernels (B21 products, B24 chains, or B22 and B23 on the split
arm), each member's boundary glue
the single-model one; ``batch_stats_stacked`` (``ops/fb_chunked.py``) is its
chunked E-step counterpart.

Lane geometry: the JAX package picks ``lane_T`` from TPU rate tables,
which do not carry over; here it is :data:`DEFAULT_LANE_T` capped at the
input's power-of-two size (:func:`pick_lane_T`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_onehot, fb_pallas
from cpgisland_tpu_torch.ops.fb_chunked import (
    DEFAULT_T_TILE,
    _assemble_reduced_stats,
    _batch_lane_setup,
    _gamma0_full,
)
from cpgisland_tpu_torch.ops.fb_pallas import seq_sum
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.ops.prepared import (
    PreparedSeq,
    check_seq,
    prepare_chunked,
    prepare_seq,
)
from cpgisland_tpu_torch.ops.viterbi_onehot import GROUP, _groups
from cpgisland_tpu_torch.ops.viterbi_parallel import associative_scan
from cpgisland_tpu_torch.parallel.fb_sharded import (
    device_boundary_messages,
    entry_symbols,
    shard_params,
)

# Steps per lane (the JAX package's legacy DEFAULT_LANE_T).  At a 64 Mi
# span that is 8192 lanes, one B4 / B7 chain per thread each.
DEFAULT_LANE_T = 8192

_F32 = torch.float32


def pick_lane_T(n: int) -> int:
    """Lane length for an ``n``-symbol span: DEFAULT_LANE_T, capped at the
    power of two at or above ``n`` so a small input is one short lane."""
    p = 8
    while p < n:
        p <<= 1
    return min(DEFAULT_LANE_T, p)


def _check_engine(engine: str) -> bool:
    """True for the reduced engine, False for the dense one."""
    if engine not in ("onehot", "pallas"):
        raise ValueError(f"fb_seq engine must be onehot|pallas, got {engine!r}")
    return engine == "onehot"


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(seq_sum(v, -1), 1e-30)[..., None]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., K, K] x [..., K, K] (+, x) product; each entry a K-term sum
    in order (for K = 2 one rounded addition)."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., :, j : j + 1] * b[..., j : j + 1, :]
    return acc


def _vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """out[..., j] = sum_k v[..., k] * m[..., k, j], in order of k."""
    acc = v[..., 0:1] * m[..., 0, :]
    for k in range(1, m.shape[-2]):
        acc = acc + v[..., k : k + 1] * m[..., k, :]
    return acc


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[..., i] = sum_j m[..., i, j] * v[..., j], in order of j."""
    acc = m[..., :, 0] * v[..., 0:1]
    for j in range(1, m.shape[-1]):
        acc = acc + m[..., :, j] * v[..., j : j + 1]
    return acc


def _lane_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized K x K matrix combine (the (+, x) semiring), the total
    summed row-major in order."""
    m = _mm(a, b)
    tot = seq_sum(m.flatten(-2), -1)
    return m / torch.clamp_min(tot, 1e-30)[..., None, None]


def _scan(red: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of lane products with the combination tree of
    ``jax.lax.associative_scan``; ``reverse`` gives the suffix products
    R[n] = red[n] . red[n+1] . ..."""
    if not reverse:
        return associative_scan(lambda a, b: [_lane_combine(a[0], b[0])], [red])[0]
    rev = associative_scan(lambda a, b: [_lane_combine(b[0], a[0])], [red.flip(0)])[0]
    return rev.flip(0)


def _scatter_rows(red: torch.Tensor, g: torch.Tensor, K: int) -> torch.Tensor:
    """[NL, 2] group components -> [NL, K] (zero fill); g [NL, 2] state ids."""
    iK = torch.arange(K, device=red.device)
    return (torch.where(iK[None, :] == g[:, 0:1], red[:, 0:1], 0.0)
            + torch.where(iK[None, :] == g[:, 1:2], red[:, 1:2], 0.0))


def _prep_for(params: HmmParams, obs, length, lane_T, first, prev_sym, prepared,
              onehot: bool = True):
    """The span's prep for the engine: ``prepared`` (checked against this
    call; its lane geometry wins unless ``lane_T`` is given), else built
    here with ``lane_T`` or :func:`pick_lane_T`."""
    S = params.n_symbols
    if prepared is None:
        return prepare_seq(S, obs, length, lane_T=lane_T or pick_lane_T(obs.shape[0]),
                           first=first, prev_sym=prev_sym, onehot=onehot)
    check_seq(prepared, S, obs.shape[0], lane_T or prepared.lane_T, first, prev_sym,
              onehot=onehot)
    return prepared


def _check_continuation(first: bool, enter_dir) -> None:
    if not first and enter_dir is None:
        raise ValueError(
            "continuation spans (first=False) need enter_dir — the "
            "entering-alpha direction from the previous span"
        )


def _boundary_dirs(params: HmmParams, o0: int, first: bool, enter_dir, exit_dir):
    """(base_dir, anchor): the direction entering lane 0 (the init at a
    record's start, else the threaded ``enter_dir``) and the exiting-beta
    direction of the last lane (uniform at a free end)."""
    K = params.n_states
    B, pi = params.B.to(_F32), params.pi.to(_F32)
    dev = pi.device
    base_dir = (_norm_rows(pi * B[:, o0]) if first
                else _norm_rows(torch.as_tensor(enter_dir, dtype=_F32, device=dev)))
    anchor = (torch.full((K,), 1.0 / K, dtype=_F32, device=dev) if exit_dir is None
              else _norm_rows(torch.as_tensor(exit_dir, dtype=_F32, device=dev)))
    return base_dir, anchor


def _lane_v0(prep: PreparedSeq, enters, A, B, pi, first: bool) -> torch.Tensor:
    """Each lane's v_0 [NL, K], unnormalized (its sum is that position's
    Rabiner c): the entering direction through A and the lane's first
    emission; lane 0 holds the init on a first span, an empty lane 1/K."""
    NL, K = enters.shape
    v0 = _vecmat(enters, A) * B[:, prep.first_syms.long()].T
    if first:
        v0[0] = pi * B[:, prep.o0]
    return torch.where((prep.lane_lens > 0)[:, None], v0,
                       torch.full((NL, K), 1.0 / K, dtype=_F32, device=A.device))


def _lane_streams_dense(params: HmmParams, obs: torch.Tensor, length: int,
                        lane_T: Optional[int] = None, *, enter_dir=None, exit_dir=None,
                        first: bool = True, conf_mask=None,
                        prepared: Optional[PreparedSeq] = None, with_enters: bool = False,
                        phase1: Optional["ShardProducts"] = None):
    """The dense branch of ``_lane_streams``: B17 products -> the two
    [NL, K, K] boundary scans -> entering / exiting directions and each
    lane's v_0 -> B16 and B18 (or B19 with ``conf_mask``).  Returns
    (alphas [lane_T, K, NL], betas [lane_T, K, NL] — or the confidence
    [lane_T, NL] with ``conf_mask`` —, lens2); ``with_enters`` adds the
    B16 scales cs [lane_T, NL], the entering directions [NL, K] and the
    prep (the seq-stats consumer's inputs)."""
    K = params.n_states
    _check_continuation(first, enter_dir)
    A, B, pi = fb_pallas.tables(params)
    if phase1 is not None:
        prep, P = phase1.prep, phase1.prods
    else:
        prep = _prep_for(params, obs, length, lane_T, first, None, prepared, onehot=False)
        P = fb_pallas._run_products_kernel(A, B, prep.sel2)  # [NL, K, K]
    base_dir, anchor = _boundary_dirs(params, prep.o0, first, enter_dir, exit_dir)
    eye = torch.eye(K, dtype=_F32, device=A.device)[None]
    excl = torch.cat([eye, _scan(P)[:-1]], dim=0)  # prefix products
    enters = _norm_rows(_vecmat(base_dir, excl))  # [NL, K]
    Rsuf = _scan(P, reverse=True)
    beta_exits = torch.cat([_norm_rows(_matvec(Rsuf[1:], anchor)), anchor[None]], dim=0)
    v0 = _lane_v0(prep, enters, A, B, pi, first)
    lens2 = prep.lane_lens[None, :].contiguous()
    alphas, cs, third = fb_pallas._run_fb_kernels(
        A, B, prep.steps2, lens2, v0.T, beta_exits.T, prep.lane_T, conf_mask=conf_mask)
    if with_enters:
        return alphas, third, lens2, cs, enters, prep
    return alphas, third, lens2


def _reduced_lane_inputs(params: HmmParams, prep: PreparedSeq, red: torch.Tensor, first: bool,
                         enter_dir, exit_dir):
    """One member's boundary glue of the reduced engine: from its lane
    products ``red`` [NL, 2, 2], the two scans -> each lane's v_0 [NL, K]
    and exiting beta [NL, K] (B4's entering vectors), and the entering
    directions in the group space, enters_red [NL, 2] (row 0: the base
    direction's components in lane 0's entry group, not renormalized — the
    JAX package's contract for B5's t == 0 pairs).  Shared by the
    single-model and the stacked lane streams, so both feed B4 / B24 the
    same bits."""
    K = params.n_states
    A, B, pi = params.A.to(_F32), params.B.to(_F32), params.pi.to(_F32)
    gt = _groups(params)
    gin, gout = gt[prep.e_in.long()], gt[prep.e_out.long()]  # [NL, 2]
    incl_red = _scan(red)

    base_dir, anchor = _boundary_dirs(params, prep.o0, first, enter_dir, exit_dir)

    # Entering-alpha directions in the 2-component group space, scattered to
    # the dense [K] rows; lane 0 enters with the FULL base direction (a
    # threaded enter_dir may carry mass outside lane 0's entry group, which
    # reaches its v_0 through A).
    eye2 = torch.eye(GROUP, dtype=_F32, device=A.device)[None]
    excl_red = torch.cat([eye2, incl_red[:-1]], dim=0)
    base_red = base_dir[gin[0]]
    enters_red = _norm_rows(_vecmat(base_red, excl_red))
    enters_red[0] = base_red
    enters = _scatter_rows(enters_red, gin, K)
    enters[0] = base_dir
    Rsuf_red = _scan(red, reverse=True)
    anchor_red = anchor[gout[-1]]
    beta_exits_red = torch.cat(
        [_norm_rows(_matvec(Rsuf_red[1:], anchor_red)), anchor_red[None]],
        dim=0,
    )
    beta_exits = _scatter_rows(beta_exits_red, gout, K)
    return _lane_v0(prep, enters, A, B, pi, first), beta_exits, enters_red


def _lane_streams(params: HmmParams, obs: torch.Tensor, length: int,
                  lane_T: Optional[int] = None, *,
                  enter_dir=None, exit_dir=None, first: bool = True, conf_mask=None,
                  prev_sym: Optional[int] = None, prepared: Optional[PreparedSeq] = None,
                  one_pass: bool = False, return_reduced: bool = False, fused: bool = True,
                  phase1: Optional["ShardProducts"] = None):
    """Lane transfer products -> boundary messages -> the reduced streams.

    ``first``: this span starts the sequence (global position 0 is the
    init).  ``enter_dir`` ([K], needed when not ``first``): the
    entering-alpha direction from the previous span; ``exit_dir`` ([K],
    optional): the exiting-beta direction from the next span (None: a free
    end).  Returns (alphas2 [lane_T, 2, NL], betas2 [lane_T, 2, NL] —
    or, with ``conf_mask``, the confidence [lane_T, NL] —, esym2, lens2).

    ``one_pass``: B8 runs first (it needs no boundary message), the lane
    products ``red`` come from its epilogue, the boundary glue below is
    unchanged, and :func:`fb_onehot.contract_mat_streams` applies the entry
    directions: one T-scaling pass in place of B7 and B4.  The streams then
    carry matrix-total scales — exact for every scale-free consumer.
    Otherwise ``fused`` picks the chains: B4 (self-normalized betas) or the
    split arm's B9 and B10 (cs-scaled betas; B11 with ``conf_mask``).
    ``return_reduced`` (without ``conf_mask``): return (alphas2, betas2,
    esym2, lens2, prep, enters_red, ll_lane) for the seq-stats consumer;
    ll_lane is the one-pass arm's telescoped loglik [1, NL]
    (:func:`fb_onehot.mat_loglik_lanes`), None on the two-pass arm.
    ``phase1`` (:func:`shard_products`, a mesh shard's first phase): the
    prep and the lane products (B8's streams on the one-pass arm) already
    built for the exchange."""
    _check_continuation(first, enter_dir)
    if phase1 is not None:
        prep = phase1.prep
    else:
        prep = _prep_for(params, obs, length, lane_T, first, prev_sym, prepared)
    lens2 = prep.lane_lens[None, :].contiguous()
    if phase1 is not None:
        red = phase1.prods
        if one_pass:
            va, wb, esym2, _ = phase1.mat
    elif one_pass:
        va, wb, esym2, red = fb_onehot.run_fb_mat_onehot(
            params, lens2, prep.lane_T, (prep.pair2, None, prep.pairn2))
    else:
        red = fb_onehot.products_reduced(params, prep.pair2)  # [NL, 2, 2]
    v0, beta_exits, enters_red = _reduced_lane_inputs(params, prep, red, first, enter_dir,
                                                      exit_dir)
    ll_lane = None
    if one_pass:
        gt = _groups(params)
        al2, third2 = fb_onehot.contract_mat_streams(va, wb, v0.T, beta_exits.T, gt, esym2)
        del wb
        if conf_mask is not None:
            third2 = fb_onehot.conf_from_reduced(al2, third2, esym2, lens2, conf_mask, gt)
        elif return_reduced:
            ll_lane = fb_onehot.mat_loglik_lanes(va, al2, lens2)
    else:
        al2, third2, esym2 = fb_onehot.run_fb_kernels_onehot(
            params, None, None, lens2, v0.T, beta_exits.T, prep.lane_T,
            pair_esym=(prep.pair2, None, prep.pairn2), conf_mask=conf_mask, fused=fused,
        )
    if return_reduced and conf_mask is None:
        return al2, third2, esym2, lens2, prep, enters_red, ll_lane
    return al2, third2, esym2, lens2


def _lane_streams_stacked(params_list, obs: torch.Tensor, length: int,
                          lane_T: Optional[int] = None, *, conf_masks=None,
                          prepared: Optional[PreparedSeq] = None, fused: bool = True,
                          first: bool = True, enter_dirs=None, exit_dirs=None,
                          phase1: Optional[tuple] = None):
    """:func:`_lane_streams` for M reduced members of one alphabet over one
    record (by default a first span with a free end): the symbol-only prep
    is built once, every member's lane products come from one launch of
    B21, the boundary glue runs per member (:func:`_reduced_lane_inputs`),
    and the chains from one launch of B24 (``fused``) or of B22 and B23.
    The counterpart of the JAX package's ``fb_pallas._lane_streams_stacked``.
    A later shard of a mesh (:func:`seq_posterior_stacked_sharded`) passes
    ``first=False``, each member's entering / exiting directions
    (``enter_dirs`` / ``exit_dirs``) and ``phase1``, its (prep, per-member
    lane products).  Returns (alphas [M, lane_T, 2, NL], betas [M, lane_T,
    2, NL] — or, with ``conf_masks``, the list of per-member confidences
    [lane_T, NL] —, esym2, lens2)."""
    fb_onehot.check_stacked_members(params_list)
    if phase1 is not None:
        prep, reds = phase1
    else:
        prep = _prep_for(params_list[0], obs, length, lane_T, True, None, prepared)
        reds = fb_onehot.products_reduced_stacked(params_list, prep.pair2)
    M = len(params_list)
    enter_dirs = [None] * M if enter_dirs is None else enter_dirs
    exit_dirs = [None] * M if exit_dirs is None else exit_dirs
    inputs = [_reduced_lane_inputs(p, prep, red, first, e, x)[:2]
              for p, red, e, x in zip(params_list, reds, enter_dirs, exit_dirs)]
    lens2 = prep.lane_lens[None, :].contiguous()
    al, third, esym2 = fb_onehot.run_fb_kernels_onehot_stacked(
        params_list, lens2, [v0.T for v0, _ in inputs], [b.T for _, b in inputs], prep.lane_T,
        pair_esym=(prep.pair2, None, prep.pairn2), conf_masks=conf_masks, fused=fused,
    )
    return al, third, esym2, lens2


def _not_lane0(NL: int, dev) -> torch.Tensor:
    """[NL] bool, False at lane 0 only — built on the device: setting one
    element from a host scalar would stall the stream (the device EM loop
    makes no synchronizing call)."""
    return torch.arange(NL, device=dev) != 0


def _scale_free_stats(params: HmmParams, alphas, betas, cs, steps2, lens2, enters,
                      length: int, is_first: bool = True) -> SuffStats:
    """The JAX package's scale-free assembly (``_gamma_emit_loglik`` and the
    per-pair xi of ``_seq_stats_core``) for dense [Tp, K, NL] streams of a
    first span: gamma_t = normalize(alpha_t * beta_t); xi per pair divided
    by its own total, so only the betas' directions matter; lane 0's pair
    uses the entering direction, and the global init has no pair.  Sums
    over K run in order; the sums over time and lanes, and the xi
    contraction (one full-f32 matmul), run as tensor reductions.
    ``is_first=False`` (a later shard of a mesh, or a continuation span):
    no init, and lane 0's pair counts from its entering direction."""
    K, S = params.n_states, params.n_symbols
    A, B = params.A.to(_F32), params.B.to(_F32)
    Tp, NL = steps2.shape
    dev = A.device
    vmask = torch.arange(Tp, device=dev)[:, None] < lens2  # [Tp, NL]
    loglik = torch.sum(torch.where(vmask, torch.log(torch.clamp_min(cs, 1e-30)), 0.0))
    graw = alphas * betas
    gamma = graw / torch.clamp_min(seq_sum(graw, 1), 1e-30)[:, None, :]
    del graw
    gamma = torch.where(vmask[:, None, :], gamma, 0.0)
    emit = torch.stack([torch.sum(torch.where((steps2 == s)[:, None, :], gamma, 0.0), dim=(0, 2))
                        for s in range(S)], dim=1)  # [K, S]
    at_init = is_first and length > 0
    init = gamma[0, :, 0] if at_init else torch.zeros(K, dtype=_F32, device=dev)
    del gamma
    w = fb_pallas.emit_sel(B, steps2.long()).permute(1, 0, 2) * betas  # [Tp, K, NL]
    a_hat = alphas / torch.clamp_min(cs[:, None, :], 1e-30)
    a_prev = torch.cat([enters.T[None], a_hat[:-1]], dim=0)
    del a_hat
    # The global init (lane 0, t == 0) has no incoming pair.
    pair = torch.cat([vmask[:1] & _not_lane0(NL, dev)[None, :], vmask[1:]]) if is_first else vmask
    a_prev = torch.where(pair[:, None, :], a_prev, 0.0)
    # Aw[t, j] = sum_k A[j, k] w[t, k], in order of k.
    Aw = A[None, :, 0:1] * w[:, 0:1, :]
    for k in range(1, K):
        Aw = Aw + A[None, :, k : k + 1] * w[:, k : k + 1, :]
    z = seq_sum(a_prev * Aw, 1)  # [Tp, NL]: each pair's xi total
    del Aw
    a_scaled = a_prev / torch.clamp_min(z, 1e-30)[:, None, :]
    del a_prev
    if a_scaled.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the xi contraction needs full f32 matmuls (allow_tf32 is set)")
    counts = a_scaled.permute(1, 0, 2).reshape(K, -1) @ w.permute(1, 0, 2).reshape(K, -1).T
    n_seqs = torch.full((), int(at_init), dtype=torch.int32, device=dev)
    return SuffStats(init=init, trans=A * counts, emit=emit, loglik=loglik, n_seqs=n_seqs)


def seq_stats(params: HmmParams, obs: torch.Tensor, length: int, *,
              lane_T: Optional[int] = None, engine: str = "onehot",
              prepared: Optional[PreparedSeq] = None, one_pass: bool = False,
              t_tile: int = DEFAULT_T_TILE, fused: bool = True, is_first: bool = True,
              enter_dir=None, exit_dir=None, prev_sym: Optional[int] = None,
              phase1: Optional["ShardProducts"] = None) -> SuffStats:
    """Exact whole-sequence sufficient statistics of ONE sequence on one
    device (n_seqs 1): the counterpart of ``seq_stats_pallas`` and its
    ``_seq_stats_core(axis=None)``.

    Reduced engine (``engine="onehot"``) with a power-of-two alphabet: the
    streams of :func:`_lane_streams` go to B5 (z-normalized counts, in
    segments of ``fb_onehot.stats_segment_t`` steps) with the entering
    directions for each lane's t == 0 pair; with ``one_pass`` the streams come from B8 and the
    loglik from :func:`fb_onehot.mat_loglik_lanes` (B5's sum of log c reads
    matrix-scaled alphas).  The dense engine (``"pallas"``: B17, B16, B18),
    and a reduced model whose alphabet is not a power of two (its streams
    scattered to dense), take the scale-free assembly
    (:func:`_scale_free_stats`).  ``one_pass`` applies to the first branch
    only; elsewhere the two-pass arm runs, bit for bit as without it.
    ``fused=False`` runs the reduced engine's split chains (B9, B10): B5 is
    z-normalized, so it is exact over their cs-scaled betas.  ``prepared``:
    the sequence's prep for the engine (built here otherwise).  ``t_tile``
    is the JAX package's segment knob, kept in the signature: no kernel of
    this route reads it.

    One shard of a mesh (``_seq_stats_core`` with an ``axis``;
    :func:`seq_stats_sharded`): ``is_first`` marks the shard that holds
    the sequence's init (shard 0); the others enter with their
    ``enter_dir`` from the exchange and, on the reduced engine, their entry
    symbol ``prev_sym``; every shard leaves with its ``exit_dir``;
    ``phase1``: the shard's prep and lane products from
    :func:`shard_products`."""
    onehot = _check_engine(engine)
    K, S = params.n_states, params.n_symbols
    if onehot:
        kernel_stats = S & (S - 1) == 0
        al2, b2, esym2, lens2, prep, enters_red, ll_lane = _lane_streams(
            params, obs, length, lane_T, prepared=prepared, one_pass=one_pass and kernel_stats,
            return_reduced=True, fused=fused, first=is_first, enter_dir=enter_dir,
            exit_dir=exit_dir, prev_sym=prev_sym, phase1=phase1)
        gt = _groups(params)
        if not kernel_stats:
            # Scattered to dense [Tp, K, NL] (exact: out-of-group entries are
            # zeros wherever they are multiplied in); lane 0's entering row
            # is never read (the global init has no pair).
            scatter = lambda x: fb_onehot.scatter_streams(x, gt, esym2, K)
            enters = _scatter_rows(enters_red, gt[prep.e_in.long()], K)
            return _scale_free_stats(params, scatter(al2), scatter(b2), al2[:, 0] + al2[:, 1],
                                     esym2, lens2, enters, int(length), is_first)
        NL = al2.shape[2]
        ent_full = fb_onehot.scatter_streams(enters_red.T[None], gt, prep.e_in[None, :], K)[0]
        pair0_mask = (_not_lane0(NL, al2.device) if is_first  # the global init
                      else torch.ones(NL, dtype=torch.bool, device=al2.device)).to(_F32)[None, :]
        macc, emit_red, ll = fb_onehot.run_seq_stats_onehot(
            params, al2, b2, prep.pair2, lens2, gt, enters_red.T.contiguous(),
            ent_full.contiguous(), pair0_mask)
        if one_pass:
            ll = ll_lane
        trans, emit, loglik = _assemble_reduced_stats(params, params.A.to(_F32), gt, macc,
                                                      emit_red, ll)
        g0f = _gamma0_full(al2, b2, gt, esym2, K)
        at_init = is_first and int(length) > 0
        init = g0f[:, 0] if at_init else torch.zeros(K, dtype=_F32, device=al2.device)
        return SuffStats(init=init, trans=trans, emit=emit, loglik=loglik,
                         n_seqs=torch.full((), int(at_init), dtype=torch.int32,
                                           device=al2.device))
    alphas, betas, lens2, cs, enters, prep = _lane_streams_dense(
        params, obs, length, lane_T, prepared=prepared, with_enters=True, first=is_first,
        enter_dir=enter_dir, exit_dir=exit_dir, phase1=phase1)
    return _scale_free_stats(params, alphas, betas, cs, prep.steps2, lens2, enters, int(length),
                             is_first)


def _conf_path_from_streams(alphas2, betas2, esym2, lens2, island_mask, gt):
    """(conf2 [Tp, NL] f32, path2 [Tp, NL] int32) from the reduced streams.

    The JAX package scatters the streams to dense [Tp, K, NL] and reduces
    over K; every dense entry outside the position's group is an exact
    zero, so this gives the same bits without the scatter: the island sum
    and the total are sums of the two group terms, and the argmax is the
    group's low state unless the high one is strictly larger (first-max
    ties), or state 0 when both terms are 0 (the dense argmax of all
    zeros)."""
    conf2 = fb_onehot.conf_from_reduced(alphas2, betas2, esym2, lens2, island_mask, gt)
    g_lo, g_hi = fb_onehot.group_select(esym2, gt.to(torch.int32))
    graw0 = alphas2[:, 0] * betas2[:, 0]
    graw1 = alphas2[:, 1] * betas2[:, 1]
    state = torch.where(graw1 > graw0, g_hi, g_lo)
    state = torch.where((graw0 == 0) & (graw1 == 0), 0, state)
    vmask = torch.arange(alphas2.shape[0], device=alphas2.device)[:, None] < lens2
    return conf2, torch.where(vmask, state, 0).to(torch.int32)


def seq_posterior(params: HmmParams, obs: torch.Tensor, length: int, island_mask, *,
                  enter_dir=None, exit_dir=None, first: bool = True, want_path: bool = False,
                  lane_T: Optional[int] = None, prev_sym: Optional[int] = None,
                  prepared: Optional[PreparedSeq] = None, engine: str = "onehot",
                  one_pass: bool = False, fused: bool = True,
                  phase1: Optional["ShardProducts"] = None):
    """Single-device posterior of one span: (conf [T] f32, MPM path [T]
    int32 — zeros unless ``want_path``), on ``obs``'s device (the params'
    device).  The twin of ``seq_posterior_pallas`` and its
    ``_seq_posterior_core``, through the reduced (``engine="onehot"``) or
    the dense (``"pallas"``) kernels; without ``want_path`` the dense
    engine's backward (B19) emits the confidence directly.  ``one_pass``
    (reduced engine; ignored on the dense one, as in the JAX package): B8
    in place of B7 and B4; else ``fused=False`` (reduced engine) runs the
    split chains, B9 with B11 (confidence only) or B10.

    ``island_mask``: [K] 0/1, the island states; conf[t] is the posterior
    mass on them.  ``prepared``: the span's :class:`PreparedSeq` for the
    same engine, shared with its transfer-total sweep.  ``lane_T``
    default: the prep's, else :func:`pick_lane_T`.  Continuation spans
    need ``enter_dir``, and on the reduced engine ``prev_sym``.  ``phase1``:
    a mesh shard's prep and lane products (:func:`shard_products`)."""
    T = obs.shape[0]
    island_mask = torch.as_tensor(island_mask, dtype=_F32, device=params.device)
    kw = dict(enter_dir=enter_dir, exit_dir=exit_dir, first=first, prepared=prepared,
              phase1=phase1)
    if not _check_engine(engine):
        if not want_path:
            _, conf2, _ = _lane_streams_dense(params, obs, length, lane_T,
                                              conf_mask=island_mask, **kw)
            return conf2.T.reshape(-1)[:T], torch.zeros(T, dtype=torch.int32, device=obs.device)
        alphas, betas, lens2 = _lane_streams_dense(params, obs, length, lane_T, **kw)
        conf2, path2 = fb_pallas._conf_path_from_streams(alphas, betas, lens2, island_mask)
        return conf2.T.reshape(-1)[:T], path2.T.reshape(-1)[:T]
    kw["one_pass"] = one_pass
    kw["fused"] = fused
    if not want_path:
        _, conf2, _, _ = _lane_streams(params, obs, length, lane_T, conf_mask=island_mask,
                                       prev_sym=prev_sym, **kw)
        # Lane n covers positions [n * lane_T, (n + 1) * lane_T): back to
        # global order, pad sliced off.
        return conf2.T.reshape(-1)[:T], torch.zeros(T, dtype=torch.int32, device=obs.device)
    al2, b2, esym2, lens2 = _lane_streams(params, obs, length, lane_T, prev_sym=prev_sym, **kw)
    conf2, path2 = _conf_path_from_streams(al2, b2, esym2, lens2, island_mask, _groups(params))
    return conf2.T.reshape(-1)[:T], path2.T.reshape(-1)[:T]


def seq_posterior_stacked(params_list, obs: torch.Tensor, length: int, island_masks, *,
                          want_path: bool = False, lane_T: Optional[int] = None,
                          prepared: Optional[PreparedSeq] = None, fused: bool = True):
    """:func:`seq_posterior` (reduced engine, one first span, free end) for
    M members of one alphabet over ONE record, through the stacked kernels
    B21 and B24 (or, ``fused=False``, B22 and B23): (conf [M, T] f32, path
    [M, T] int32 — zeros unless ``want_path``).  Member m's rows equal
    ``seq_posterior(params_list[m], ..., engine="onehot", fused=fused)`` on
    the same input and geometry bit for bit (on the split arm the
    confidence comes from :func:`fb_onehot.conf_from_reduced`, as in the JAX
    package's stacked epilogue: B11's arithmetic).  The twin of
    ``seq_posterior_pallas_stacked``."""
    T = obs.shape[0]
    M = len(params_list)
    dev = params_list[0].device
    masks = [torch.as_tensor(m, dtype=_F32, device=dev) for m in island_masks]
    if not want_path:
        _, confs, _, _ = _lane_streams_stacked(params_list, obs, length, lane_T,
                                               conf_masks=masks, prepared=prepared, fused=fused)
        return (torch.stack([c.T.reshape(-1)[:T] for c in confs]),
                torch.zeros((M, T), dtype=torch.int32, device=obs.device))
    al, be, esym2, lens2 = _lane_streams_stacked(params_list, obs, length, lane_T,
                                                 prepared=prepared, fused=fused)
    confs, paths = [], []
    for m, params in enumerate(params_list):
        conf2, path2 = _conf_path_from_streams(al[m], be[m], esym2, lens2, masks[m],
                                               _groups(params))
        confs.append(conf2.T.reshape(-1)[:T])
        paths.append(path2.T.reshape(-1)[:T])
    return torch.stack(confs), torch.stack(paths)


def batch_posterior(params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                    island_mask, *, want_path: bool = False, t_tile: int = DEFAULT_T_TILE,
                    engine: str = "onehot", fused: bool = True):
    """Posterior of a [N, T] batch of independent records, one record per
    lane (the chunked layout: pi at the start, a free end — exact, since
    each record fits its lane), through B4 (``engine="onehot"``; with
    ``fused=False`` B9 and B11, or B10 with ``want_path``) or B16 with B18 /
    B19 (``"pallas"``).  Returns (conf [N, T] f32, path [N, T]
    int32 — zeros unless ``want_path``).  The twin of
    ``batch_posterior_pallas``."""
    onehot = _check_engine(engine)
    S = params.n_symbols
    N, T = chunks.shape
    prep = prepare_chunked(S, chunks, lengths, t_tile=t_tile, onehot=onehot)
    _, a0_raw, beta0, _ = _batch_lane_setup(params, prep)
    mask = torch.as_tensor(island_mask, dtype=_F32, device=params.device)
    no_path = torch.zeros((N, T), dtype=torch.int32, device=chunks.device)
    if not onehot:
        A, B, _ = fb_pallas.tables(params)
        if not want_path:
            _, _, conf2 = fb_pallas._run_fb_kernels(A, B, prep.steps2, prep.lens2, a0_raw,
                                                    beta0, T, conf_mask=mask)
            return conf2.T[:N, :T], no_path
        alphas, _, betas = fb_pallas._run_fb_kernels(A, B, prep.steps2, prep.lens2, a0_raw,
                                                     beta0, T)
        conf2, path2 = fb_pallas._conf_path_from_streams(alphas, betas, prep.lens2, mask)
        return conf2.T[:N, :T], path2.T[:N, :T]
    streams = (prep.pair2, prep.esym2, prep.pairn2)
    if not want_path:
        _, conf2, _ = fb_onehot.run_fb_kernels_onehot(
            params, None, None, prep.lens2, a0_raw, beta0, T, pair_esym=streams,
            conf_mask=mask, fused=fused,
        )
        return conf2.T[:N, :T], no_path
    al2, b2, esym2 = fb_onehot.run_fb_kernels_onehot(
        params, None, None, prep.lens2, a0_raw, beta0, T, pair_esym=streams, fused=fused,
    )
    conf2, path2 = _conf_path_from_streams(al2, b2, esym2, prep.lens2, mask, _groups(params))
    return conf2.T[:N, :T], path2.T[:N, :T]


def seq_transfer_total(params: HmmParams, obs: torch.Tensor, length: int, *,
                       first: bool = True, lane_T: Optional[int] = None,
                       prev_sym: Optional[int] = None,
                       prepared: Optional[PreparedSeq] = None,
                       engine: str = "onehot") -> torch.Tensor:
    """Normalized [K, K] transfer operator M of one span (alpha_dir_out ∝
    alpha_dir_in @ M): the products-only sweep of span threading (B7 or,
    on the dense engine, B17).  On the reduced engine only the entries
    between the span's entry and exit groups are nonzero.  ``first`` masks
    global position 0 (the init) — True only for a record's first span;
    reduced continuation spans need ``prev_sym``."""
    onehot = _check_engine(engine)
    prep = _prep_for(params, obs, length, lane_T, first, prev_sym if onehot else None,
                     prepared, onehot=onehot)
    if not onehot:
        A, B, _ = fb_pallas.tables(params)
        return _scan(fb_pallas._run_products_kernel(A, B, prep.sel2))[-1]
    red = fb_onehot.products_reduced(params, prep.pair2)
    total_red = _scan(red)[-1:]
    return fb_onehot._scatter_products_prob(
        total_red, _groups(params), prep.e_in[:1], prep.e_out[-1:], params.n_states
    )[0]


# ---------------------------------------------------------------------------
# Sequence-parallel over a mesh: every shard's lane products, the exchange
# of ``parallel.fb_sharded.device_boundary_messages``, then every shard's
# chains from its messages (the JAX package's ``_lane_streams`` with an
# ``axis``).


@dataclasses.dataclass
class ShardProducts:
    """A mesh shard's first phase: its prep, its lane products (reduced
    [NL, 2, 2] or dense [NL, K, K]), B8's streams on the one-pass arm
    (``mat``, else None), its normalized [K, K] transfer total (dense, for
    the exchange) and its init direction ``a0_dir`` (read on shard 0)."""

    prep: PreparedSeq
    prods: torch.Tensor
    mat: Optional[tuple]
    total: torch.Tensor
    a0_dir: torch.Tensor


def shard_products(params: HmmParams, obs: torch.Tensor, length: int, lane_T: int, *,
                   first: bool, prev_sym: Optional[int], prepared: Optional[PreparedSeq],
                   onehot: bool, one_pass: bool = False) -> ShardProducts:
    """Phase 1 of one shard: its prep (built here unless ``prepared``) and
    lane products through B7 (B8 with ``one_pass``) or B17, and the total
    the exchange reads (the reduced total scattered to [K, K]: its
    out-of-group entries are exact zeros).  ``first``: this shard holds the
    sequence's init; ``prev_sym``: the symbol before it (reduced engine,
    ``first=False``)."""
    K = params.n_states
    prep = _prep_for(params, obs, length, lane_T, first, prev_sym if onehot else None,
                     prepared, onehot=onehot)
    mat = None
    if onehot:
        if one_pass:
            lens2 = prep.lane_lens[None, :].contiguous()
            mat = fb_onehot.run_fb_mat_onehot(params, lens2, prep.lane_T,
                                             (prep.pair2, None, prep.pairn2))
            prods = mat[3]
        else:
            prods = fb_onehot.products_reduced(params, prep.pair2)
        total = fb_onehot._scatter_products_prob(
            _scan(prods)[-1:], _groups(params), prep.e_in[:1], prep.e_out[-1:], K)[0]
    else:
        A, B, _ = fb_pallas.tables(params)
        prods = fb_pallas._run_products_kernel(A, B, prep.sel2)
        total = _scan(prods)[-1]
    a0_dir = _norm_rows(params.pi.to(_F32) * params.B.to(_F32)[:, prep.o0])
    return ShardProducts(prep=prep, prods=prods, mat=mat, total=total, a0_dir=a0_dir)


def _sharded_phase1(params: HmmParams, shards, lengths, lane_T: int, *, onehot: bool,
                    one_pass: bool, prepared, entry_syms, first: bool, prev_sym,
                    enter_dir, exit_dir):
    """Every shard's first phase and the exchange -> (per-shard params,
    phase-1 results, entering directions, exiting directions, entry
    symbols)."""
    if not first and enter_dir is None:
        raise ValueError("continuation spans (first=False) need enter_dir — the "
                         "entering-alpha direction from the previous span")
    S = params.n_symbols
    ps = shard_params(params, shards)
    if onehot and entry_syms is None:
        entry_syms = entry_symbols(shards, lengths, S, 0 if first else int(prev_sym))
    ph = []
    for d, (p, o, n) in enumerate(zip(ps, shards, lengths)):
        is_first = first and d == 0
        ps_d = None
        if onehot and not is_first:
            ps_d = int(prev_sym) if d == 0 else entry_syms[d]
        ph.append(shard_products(p, o, int(n), lane_T, first=is_first, prev_sym=ps_d,
                                 prepared=None if prepared is None else prepared[d],
                                 onehot=onehot, one_pass=one_pass))
    _, enters, exits = device_boundary_messages(
        [x.a0_dir for x in ph], [x.total for x in ph],
        start_dir=None if first else enter_dir, end_dir=exit_dir)
    return ps, ph, enters, exits, entry_syms


def seq_stats_sharded(params: HmmParams, shards, lengths, *, lane_T: int, engine: str,
                      prepared=None, entry_syms=None, one_pass: bool = False,
                      fused: bool = True) -> list:
    """:func:`seq_stats` of ONE sequence split over a mesh's shards
    (``shards``: [L] tensors in mesh order, each on its device;
    ``lengths``: host ints): every shard's lane products, the exchange,
    then every shard's chains and statistics from its messages.  Returns
    the per-shard statistics, each on its shard's device (the caller sums
    them).  ``prepared``: one :class:`PreparedSeq` per shard, built with
    :func:`prepare_shards`; ``entry_syms``: the symbol before each shard
    (read from the shards when None)."""
    onehot = _check_engine(engine)
    kernel_stats = onehot and params.n_symbols & (params.n_symbols - 1) == 0
    one_pass = bool(one_pass) and kernel_stats
    ps, ph, enters, exits, entry_syms = _sharded_phase1(
        params, shards, lengths, lane_T, onehot=onehot, one_pass=one_pass, prepared=prepared,
        entry_syms=entry_syms, first=True, prev_sym=None, enter_dir=None, exit_dir=None)
    out = []
    for d, (p, o, n) in enumerate(zip(ps, shards, lengths)):
        out.append(seq_stats(
            p, o, int(n), lane_T=lane_T, engine=engine, one_pass=one_pass,
            fused=fused, is_first=d == 0, enter_dir=enters[d], exit_dir=exits[d],
            prev_sym=entry_syms[d] if onehot and d else None, phase1=ph[d]))
        ph[d] = None
    return out


def seq_posterior_sharded(params: HmmParams, shards, lengths, island_mask, *, lane_T: int,
                          engine: str, enter_dir=None, exit_dir=None, first: bool = True,
                          want_path: bool = False, prev_sym: Optional[int] = None,
                          one_pass: bool = False, fused: bool = True) -> list:
    """:func:`seq_posterior` of one span split over a mesh's shards (the
    layout of :func:`seq_stats_sharded`): the span's messages
    ``enter_dir`` / ``exit_dir`` enter the exchange at its ends.  Returns
    the per-shard (conf [L], path [L]) in mesh order, each on its shard's
    device."""
    onehot = _check_engine(engine)
    one_pass = bool(one_pass) and onehot
    ps, ph, enters, exits, entry_syms = _sharded_phase1(
        params, shards, lengths, lane_T, onehot=onehot, one_pass=one_pass, prepared=None,
        entry_syms=None, first=first, prev_sym=prev_sym, enter_dir=enter_dir,
        exit_dir=exit_dir)
    out = []
    for d, (p, o, n) in enumerate(zip(ps, shards, lengths)):
        is_first = first and d == 0
        ps_d = None
        if onehot and not is_first:
            ps_d = int(prev_sym) if d == 0 else entry_syms[d]
        out.append(seq_posterior(
            p, o, int(n), island_mask, enter_dir=enters[d], exit_dir=exits[d],
            first=is_first, want_path=want_path, lane_T=lane_T, prev_sym=ps_d,
            engine=engine, one_pass=one_pass, fused=fused, phase1=ph[d]))
        ph[d] = None
    return out


def prepare_shards(params: HmmParams, shards, lengths, *, lane_T: int, onehot: bool,
                   entry_syms) -> list:
    """One whole-sequence :class:`PreparedSeq` per shard of a first span
    (shard 0 holds the init; the others are conditioned on their entry
    symbols), each on its shard's device."""
    S = params.n_symbols
    return [prepare_seq(S, o, int(n), lane_T=lane_T, first=d == 0,
                        prev_sym=entry_syms[d] if onehot and d else None, onehot=onehot)
            for d, (o, n) in enumerate(zip(shards, lengths))]


def seq_posterior_stacked_sharded(params_list, shards, lengths, island_masks, *, lane_T: int,
                                  want_path: bool = False, fused: bool = True) -> list:
    """:func:`seq_posterior_stacked` (a first span with a free end) of one
    record split over a mesh's shards: every shard's products of every
    member in one launch of B21, one exchange per member, then every
    shard's chains of every member in one launch of B24 (or B22 and B23).
    Returns the per-shard (conf [M, L], path [M, L]) in mesh order, each
    on its shard's device; member m's rows equal
    :func:`seq_posterior_sharded` of ``params_list[m]`` on the reduced
    engine."""
    fb_onehot.check_stacked_members(params_list)
    S, M = params_list[0].n_symbols, len(params_list)
    entry_syms = entry_symbols(shards, lengths, S, 0)
    per_dev = [shard_params(p, shards) for p in params_list]  # [M][D]
    phase1, totals, a0s = [], [], []
    for d, (o, n) in enumerate(zip(shards, lengths)):
        ps = [per_dev[m][d] for m in range(M)]
        prep = _prep_for(ps[0], o, int(n), lane_T, d == 0, entry_syms[d] if d else None, None)
        reds = fb_onehot.products_reduced_stacked(ps, prep.pair2)
        phase1.append((prep, reds))
        totals.append([fb_onehot._scatter_products_prob(
            _scan(r)[-1:], _groups(p), prep.e_in[:1], prep.e_out[-1:], p.n_states)[0]
            for p, r in zip(ps, reds)])
        a0s.append([_norm_rows(p.pi.to(_F32) * p.B.to(_F32)[:, prep.o0]) for p in ps])
    msgs = [device_boundary_messages([a0s[d][m] for d in range(len(shards))],
                                     [totals[d][m] for d in range(len(shards))])[1:]
            for m in range(M)]
    out = []
    for d, (o, n) in enumerate(zip(shards, lengths)):
        ps = [per_dev[m][d] for m in range(M)]
        T = o.shape[0]
        masks = [torch.as_tensor(x, dtype=_F32).to(o.device) for x in island_masks]
        kw = dict(first=d == 0, enter_dirs=[msgs[m][0][d] for m in range(M)],
                  exit_dirs=[msgs[m][1][d] for m in range(M)], phase1=phase1[d], fused=fused)
        phase1[d] = None
        if not want_path:
            _, confs, _, _ = _lane_streams_stacked(ps, o, int(n), lane_T, conf_masks=masks, **kw)
            out.append((torch.stack([c.T.reshape(-1)[:T] for c in confs]),
                        torch.zeros((M, T), dtype=torch.int32, device=o.device)))
            continue
        al, be, esym2, lens2 = _lane_streams_stacked(ps, o, int(n), lane_T, **kw)
        paths = [_conf_path_from_streams(al[m], be[m], esym2, lens2, masks[m], _groups(p))
                 for m, p in enumerate(ps)]
        out.append((torch.stack([c.T.reshape(-1)[:T] for c, _ in paths]),
                    torch.stack([q.T.reshape(-1)[:T] for _, q in paths])))
    return out
