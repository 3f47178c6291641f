"""One-hot-emission reduced Viterbi engine: four CUDA kernels and their
plain PyTorch versions.

Counterpart of ``cpgisland_tpu/ops/viterbi_onehot.py``.  The flagship 8-state
CpG model has ONE-HOT emissions (state X+/X- emits exactly symbol x), so at
time t the score vector is LOG_ZERO outside the G = 2 states that emit o_t:
the K-state recurrence is exactly a 2-state recurrence whose per-step matrix
is the [2, 2] slice of log A between the previous symbol's state group and
the current one's.  Backpointers pack 2 bits per step.

The three passes of ops.viterbi_parallel run in the reduced space, over the
per-step PAIR stream (p = s_prev * S + s_cur for real steps, S*S + carried
symbol for PAD steps) and a per-pair table of 2x2 step matrices; small
per-block scatters rebuild the full-K interfaces, so the shared stitching is
untouched.  The flat batch decoder's score arm runs the backpointer pass
through B6, which also emits the per-step chain max.  The kernels
(``csrc/viterbi_onehot.cu``) run one thread per lane
over the time-major [bk, nb] streams; each wrapper below launches its kernel
for a CUDA tensor, takes the plain PyTorch version for a CPU tensor, and
raises otherwise.  Max-plus is adds and maxes only, so kernel and plain
version agree bit for bit.

Exactness domain: one-hot emissions with exactly two states per symbol, and
a known real symbol before each segment's first step (``prev0``).  PAD
symbols mid-sequence and at the tail are identity steps; a segment whose
first position is PAD is outside the reduced representation (the callers in
parallel.decode refuse it).  Paths equal the JAX engine's on the same block
geometry; across geometries they agree except where two path scores tie
within f32 rounding of the per-block normalizer (both then true argmaxes).
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.family.partition import REDUCED_GROUP
from cpgisland_tpu_torch.models.hmm import LOG_ZERO, HmmParams
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops.viterbi_parallel import scan_block_products

ROW_TILE = 8  # steps per packed backpointer word (2 bits per step)
# Reduced state dimension — the family partition oracle's block size.
GROUP = REDUCED_GROUP

_I32 = torch.int32
_F32 = torch.float32


def _groups(params: HmmParams) -> torch.Tensor:
    """[S, GROUP] int64 group table: gt[s] = the two state ids whose
    emission support covers symbol s, ascending (the order that reproduces
    the generic engines' first-max tie-breaking)."""
    K = params.n_states
    supp = params.log_B > LOG_ZERO / 2  # [K, S]
    ar = torch.arange(K, device=params.device)
    low = torch.amin(torch.where(supp.T, ar[None, :], K), dim=1)
    high = torch.amax(torch.where(supp.T, ar[None, :], -1), dim=1)
    return torch.stack([low, high], dim=1)


def pair_exit_syms(S: int, device="cpu") -> torch.Tensor:
    """[S*S + S] exit symbol per pair index — THE pair-index encoding
    (p = s_prev * S + s_cur for real steps; S*S + carried symbol for PADs)."""
    ar = torch.arange(S, device=device)
    return torch.cat([ar.repeat(S), ar])


def _pair_table(params: HmmParams, gt: torch.Tensor):
    """Per-pair reduced step matrices.

    Row p < S*S (p = s_prev * S + s_cur) holds [T00, T01, T10, T11] with
    T[a, c] = logA[gt[s_prev, a], gt[s_cur, c]] + logB[gt[s_cur, c], s_cur];
    rows S*S + e are the max-plus identity (PAD steps carrying symbol e).
    Returns (tab [S*S + S, 4] f32, idtab [S*S + S, GROUP] int32 — the state
    ids of each pair's EXIT group, which the backtrace emits)."""
    S = params.n_symbols
    ar = torch.arange(S, device=params.device)
    A_red = params.log_A[gt[:, :, None, None], gt[None, None, :, :]]  # [S,2,S,2]
    B_red = params.log_B[gt, ar[:, None]]  # [S, 2]
    M = A_red + B_red[None, None, :, :]  # [sp, a, sc, c]
    real = M.permute(0, 2, 1, 3).reshape(S * S, 4).to(_F32)
    ident = torch.tensor([0.0, LOG_ZERO, LOG_ZERO, 0.0], dtype=_F32,
                         device=params.device).expand(S, 4)
    tab = torch.cat([real, ident], dim=0)
    idtab = gt[pair_exit_syms(S, params.device)].to(_I32)
    return tab, idtab


def _reset_rows(params: HmmParams, gt: torch.Tensor):
    """RESET step matrices, one per record-start symbol o (flat batch
    decode): T[a, c] = log_pi[gt[o, c]] + log_B[gt[o, c], o] for every a —
    rank-one in max-plus, so the chain restarts at record o's initial
    scores up to an additive constant that argmax paths never see."""
    S = params.n_symbols
    ar = torch.arange(S, device=params.device)
    v0red = params.log_pi[gt] + params.log_B[gt, ar[:, None]]  # [S, 2]
    rows = torch.cat([v0red, v0red], dim=1).to(_F32)  # [S, 4]
    return rows, gt.to(_I32)


def pair_stream(S: int, steps2: torch.Tensor, prev0):
    """Per-step pair indices + per-block boundary symbols.

    steps2: [bk, nb] int32 transition symbols (global step b*bk + k at
    [k, b]); prev0: the symbol emitted before step 0.  Returns (pair2
    [bk, nb] int32, e_in [nb], e_out [nb]): the symbols emitted by the
    states entering / exiting each block, PADs resolved by forward fill.
    Two-level fill: a cummax along the block axis resolves in-block PAD
    runs, a tiny [nb] cummax threads the last real symbol across blocks."""
    bk, nb = steps2.shape
    dev = steps2.device
    real = steps2 < S
    iota = torch.arange(bk, dtype=_I32, device=dev)[:, None]
    minus1 = torch.tensor(-1, dtype=_I32, device=dev)
    key = torch.where(real, iota * S + steps2, minus1)
    ckey = torch.cummax(key, dim=0).values
    in_sym = ckey - torch.div(ckey, S, rounding_mode="floor") * S  # valid where ckey >= 0
    # Cross-block seed: last real symbol of any earlier block, else prev0.
    last_key = torch.where(ckey[-1] >= 0, in_sym[-1], minus1)  # [nb]
    prev_blocks = torch.cat([minus1[None], last_key[:-1]])
    seed_key = torch.where(
        prev_blocks >= 0,
        torch.arange(nb, dtype=_I32, device=dev) * (S + 1) + prev_blocks,
        minus1,
    )
    seed_c = torch.cummax(seed_key, dim=0).values
    # prev0 is clamped so an out-of-domain PAD prev0 still indexes inside
    # the pair table (deterministic-but-approximate, never out of bounds).
    prev0 = torch.clamp_max(torch.as_tensor(prev0, dtype=_I32, device=dev), S - 1)
    seed = torch.where(
        seed_c >= 0,
        seed_c - torch.div(seed_c, S + 1, rounding_mode="floor") * (S + 1),
        prev0,
    )  # [nb]
    esym = torch.where(ckey >= 0, in_sym, seed[None, :])  # [bk, nb]
    prev_esym = torch.cat([seed[None, :], esym[:-1]], dim=0)
    pair2 = torch.where(real, prev_esym * S + steps2, S * S + esym)
    return pair2.to(_I32), seed.to(_I32), esym[-1].to(_I32)


def prepare_pairs(S: int, steps2: torch.Tensor, prev0, resets=None):
    """Symbol-only pair stream for the decode passes, reset-renumbered.

    Returns (pair2, e_in, e_out, nreal).  ``resets`` (flat batch decoding):
    a [bk, nb] bool mask — step [k, b] is a RESET step into a record whose
    start symbol is steps2[k, b].  RESET pairs take indices [S*S, S*S + S)
    and PAD carries move up to [S*S + S, S*S + 2S)."""
    if prev0 is None:
        raise ValueError("the onehot engine requires prev0 (the symbol before step 0)")
    # One copy into the time-major layout: every stream derived below (and
    # handed to the kernels) is then contiguous.
    steps2 = steps2.to(_I32).contiguous()
    pair2, e_in, e_out = pair_stream(S, steps2, prev0)
    nreal = S * S
    if resets is not None:
        pair2 = torch.where(pair2 >= S * S, pair2 + S, pair2)
        pair2 = torch.where(resets, S * S + torch.clamp_max(steps2, S - 1), pair2)
        nreal = S * S + S
    return pair2, e_in, e_out, nreal


def _prepared(params: HmmParams, steps2, prev0, resets=None, pre=None):
    """Tables + pair stream for the passes (``pre``: a prepare_pairs tuple
    built with the SAME ``resets`` mask)."""
    S = params.n_symbols
    gt = _groups(params)
    tab, idtab = _pair_table(params, gt)
    if pre is None:
        pre = prepare_pairs(S, steps2, prev0, resets)
    pair2, e_in, e_out, nreal = pre
    if resets is not None:
        if nreal != S * S + S:
            raise ValueError(
                "prepared pair stream was built without the resets mask "
                "this call passes (nreal mismatch)"
            )
        rrows, rgt = _reset_rows(params, gt)
        tab = torch.cat([tab[: S * S], rrows, tab[S * S :]], dim=0)
        idtab = torch.cat([idtab[: S * S], rgt, idtab[S * S :]], dim=0)
    elif nreal != S * S:
        raise ValueError(
            "prepared pair stream carries reset renumbering but this call "
            "passes no resets mask"
        )
    return S, gt, tab, idtab, pair2, e_in, e_out, nreal


def _pad_pair_rows(pair2: torch.Tensor, e_out: torch.Tensor, ident_base: int):
    """Pad the step axis to a multiple of ROW_TILE with per-lane identity
    pairs (ident_base + carried symbol), so padded steps keep PAD semantics
    and their carried symbol; the kernels then pack whole 8-step words."""
    bk, nb = pair2.shape
    bk_pad = -(-bk // ROW_TILE) * ROW_TILE
    if bk_pad == bk:
        return pair2
    tail = (ident_base + e_out)[None, :].expand(bk_pad - bk, nb).to(_I32)
    return torch.cat([pair2, tail], dim=0)


# ---------------------------------------------------------------------------
# The three kernels: plain PyTorch versions and the wrappers that launch the
# CUDA kernels.  Shapes are the kernels' own: pair2 [bk, nb] int32 with bk a
# multiple of ROW_TILE, tab [nP, 4] f32 (every pair's 2x2 step matrix,
# identity rows included), idtab [nP, 2] int32.


def oh_products_plain(pair2: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Pass A, plain version: the 2x2 max-plus product of each lane's
    pair-selected step matrices -> [4, nb] (rows C00, C01, C10, C11).
    Mirrors the JAX package's ``_xla_products`` op for op; selection is an
    exact gather."""
    bk, nb = pair2.shape
    T = tab[pair2.long()]  # [bk, nb, 4]
    c00 = torch.zeros(nb, dtype=_F32, device=pair2.device)
    c01 = torch.full((nb,), LOG_ZERO, dtype=_F32, device=pair2.device)
    c10 = c01.clone()
    c11 = c00.clone()
    for k in range(bk):
        t = T[k]
        n00 = torch.maximum(c00 + t[:, 0], c01 + t[:, 2])
        n01 = torch.maximum(c00 + t[:, 1], c01 + t[:, 3])
        n10 = torch.maximum(c10 + t[:, 0], c11 + t[:, 2])
        n11 = torch.maximum(c10 + t[:, 1], c11 + t[:, 3])
        c00, c01, c10, c11 = n00, n01, n10, n11
    return torch.stack([c00, c01, c10, c11])


def _pack_words(bp2: torch.Tensor) -> torch.Tensor:
    """[bk, nb] 2-bit rows (bk % 8 == 0) -> [bk/8, nb] int32 words, step r
    of a word at bits 2r..2r+1."""
    bk, nb = bp2.shape
    shifts = 2 * torch.arange(ROW_TILE, dtype=_I32, device=bp2.device)
    rows = bp2.reshape(bk // ROW_TILE, ROW_TILE, nb) << shifts[None, :, None]
    return rows.sum(dim=1, dtype=_I32)  # disjoint bits: sum == or


def _unpack_words(bp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_words`: [bk/8, nb] words -> [bk, nb] rows."""
    nw, nb = bp.shape
    shifts = 2 * torch.arange(ROW_TILE, dtype=_I32, device=bp.device)
    return ((bp[:, None, :] >> shifts[None, :, None]) & 3).reshape(nw * ROW_TILE, nb)


def _backpointers_chain(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor,
                        want_dmax: bool):
    """The reduced delta recursion both plain pass-B versions share (the
    counterpart of the kernels' ``WANT_DMAX`` template): (bp, dexit, ebits,
    dmax2 [bk, nb] or None).  With ``want_dmax`` each step also stores
    max(d0, d1), off the chain, so the first three outputs do not change."""
    bk, nb = pair2.shape
    T = tab[pair2.long()]
    d0, d1 = v_red[0].clone(), v_red[1].clone()
    E = torch.full((nb,), 0b10, dtype=_I32, device=pair2.device)
    rows = []
    dmax2 = torch.empty((bk, nb), dtype=_F32, device=pair2.device) if want_dmax else None
    for k in range(bk):
        t = T[k]
        a0 = d0 + t[:, 0]
        a1 = d1 + t[:, 2]
        b0 = d0 + t[:, 1]
        b1 = d1 + t[:, 3]
        bp0 = (a1 > a0).to(_I32)
        bp1 = (b1 > b0).to(_I32)
        E = ((E >> bp0) & 1) | (((E >> bp1) & 1) << 1)
        d0 = torch.maximum(a0, a1)
        d1 = torch.maximum(b0, b1)
        if want_dmax:
            dmax2[k] = torch.maximum(d0, d1)
        rows.append(bp0 | (bp1 << 1))
    return _pack_words(torch.stack(rows)), torch.stack([d0, d1]), E, dmax2


def oh_backpointers_plain(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Pass B, plain version: the reduced delta recursion from the entering
    vectors v_red [2, nb].  Returns (bp [bk/8, nb] int32 packed 2-bit
    backpointers, dexit [2, nb] f32, ebits [nb] int32 exit -> entry bits).
    Strict ``>`` keeps argmax first-max tie-breaking.  Mirrors
    ``_xla_backpointers``."""
    return _backpointers_chain(pair2, v_red, tab, want_dmax=False)[:3]


def oh_backpointers_scores_plain(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Pass B with score threading, plain version: (bp, dexit, ebits, dmax2
    [bk, nb]), dmax2 the running chain max max(d0, d1) after each step,
    relative to the block's normalized entering vector.  Mirrors
    ``_xla_backpointers_scores``."""
    return _backpointers_chain(pair2, v_red, tab, want_dmax=True)


def oh_backtrace_plain(bp: torch.Tensor, pair2: torch.Tensor, idtab: torch.Tensor,
                       exit_bits: torch.Tensor) -> torch.Tensor:
    """Pass C, plain version: walk the 2-bit backpointers from the exit
    bits, emitting full state ids through the pair -> exit-group table.
    Returns path [bk, nb] int32.  Mirrors ``_xla_backtrace``."""
    bk, nb = pair2.shape
    rows = _unpack_words(bp)
    ids = idtab[pair2.long()]  # [bk, nb, 2]
    path = torch.empty((bk, nb), dtype=_I32, device=pair2.device)
    bit = exit_bits.to(_I32)
    for k in range(bk - 1, -1, -1):
        path[k] = torch.where(bit == 0, ids[k, :, 0], ids[k, :, 1])
        bit = (rows[k] >> bit) & 1
    return path


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})"
        )


def _check_stream(pair2: torch.Tensor, tables) -> None:
    if pair2.dim() != 2 or pair2.shape[0] % ROW_TILE or pair2.shape[1] == 0:
        raise ValueError(
            f"pair2 must be [bk, nb] with bk a positive multiple of {ROW_TILE}, "
            f"got {tuple(pair2.shape)}"
        )
    for t in tables:
        if t.device != pair2.device:
            raise ValueError(f"all operands must share pair2's device {pair2.device}")
    if pair2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pair2.device}")


def oh_products(pair2: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Kernel B1 (replaces the JAX package's ``_oh_products_kernel``):
    [bk, nb] pairs + [nP, 4] table -> [4, nb] block products."""
    _check_stream(pair2, (tab,))
    bk, nb = pair2.shape
    nP = tab.shape[0]
    _check("pair2", pair2, _I32, (bk, nb))
    _check("tab", tab, _F32, (nP, 4))
    if pair2.device.type == "cpu":
        return oh_products_plain(pair2, tab)
    out = torch.empty((4, nb), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_products", pair2, tab, out, bk=bk, nb=nb, nP=nP)
    return out


def oh_backpointers(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Kernel B2 (replaces ``_oh_backpointers_kernel``): -> (bp [bk/8, nb]
    int32, dexit [2, nb] f32, ebits [nb] int32)."""
    _check_stream(pair2, (v_red, tab))
    bk, nb = pair2.shape
    nP = tab.shape[0]
    _check("pair2", pair2, _I32, (bk, nb))
    _check("v_red", v_red, _F32, (GROUP, nb))
    _check("tab", tab, _F32, (nP, 4))
    if pair2.device.type == "cpu":
        return oh_backpointers_plain(pair2, v_red, tab)
    bp = torch.empty((bk // ROW_TILE, nb), dtype=_I32, device=pair2.device)
    dexit = torch.empty((GROUP, nb), dtype=_F32, device=pair2.device)
    ebits = torch.empty((nb,), dtype=_I32, device=pair2.device)
    _kernels.launch("oh_backpointers", pair2, v_red, tab, bp, dexit, ebits,
                    bk=bk, nb=nb, nP=nP)
    return bp, dexit, ebits


def oh_backpointers_scores(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Kernel B6 (replaces ``_oh_backpointers_score_kernel``): B2's outputs
    plus dmax2 [bk, nb] f32, the per-step chain max -> (bp, dexit, ebits,
    dmax2)."""
    _check_stream(pair2, (v_red, tab))
    bk, nb = pair2.shape
    nP = tab.shape[0]
    _check("pair2", pair2, _I32, (bk, nb))
    _check("v_red", v_red, _F32, (GROUP, nb))
    _check("tab", tab, _F32, (nP, 4))
    if pair2.device.type == "cpu":
        return oh_backpointers_scores_plain(pair2, v_red, tab)
    bp = torch.empty((bk // ROW_TILE, nb), dtype=_I32, device=pair2.device)
    dexit = torch.empty((GROUP, nb), dtype=_F32, device=pair2.device)
    ebits = torch.empty((nb,), dtype=_I32, device=pair2.device)
    dmax2 = torch.empty((bk, nb), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_backpointers_scores", pair2, v_red, tab, bp, dexit, ebits, dmax2,
                    bk=bk, nb=nb, nP=nP)
    return bp, dexit, ebits, dmax2


def oh_backtrace(bp: torch.Tensor, pair2: torch.Tensor, idtab: torch.Tensor,
                 exit_bits: torch.Tensor) -> torch.Tensor:
    """Kernel B3 (replaces ``_oh_backtrace_kernel``): -> path [bk, nb] int32
    state ids."""
    _check_stream(pair2, (bp, idtab, exit_bits))
    bk, nb = pair2.shape
    nP = idtab.shape[0]
    _check("bp", bp, _I32, (bk // ROW_TILE, nb))
    _check("pair2", pair2, _I32, (bk, nb))
    _check("idtab", idtab, _I32, (nP, GROUP))
    _check("exit_bits", exit_bits, _I32, (nb,))
    if pair2.device.type == "cpu":
        return oh_backtrace_plain(bp, pair2, idtab, exit_bits)
    path = torch.empty((bk, nb), dtype=_I32, device=pair2.device)
    _kernels.launch("oh_backtrace", bp, pair2, idtab, exit_bits, path,
                    bk=bk, nb=nb, nP=nP)
    return path


# ---------------------------------------------------------------------------
# Scatter glue: reduced block results -> full-K interfaces


def _scatter_products(red, gt, e_in, e_out, K, fill=LOG_ZERO):
    """[nb, 2, 2] reduced block products -> [nb, K, K] full."""
    nb = red.shape[0]
    gin = gt[e_in.long()]  # [nb, 2]
    gout = gt[e_out.long()]  # [nb, 2]
    iK = torch.arange(K, device=red.device)
    full = torch.full((nb, K, K), fill, dtype=_F32, device=red.device)
    for a in range(GROUP):
        for c in range(GROUP):
            mask = (iK[None, :, None] == gin[:, a, None, None]) & (
                iK[None, None, :] == gout[:, c, None, None]
            )
            full = torch.where(mask, red[:, a, c][:, None, None], full)
    return full


def _scatter_vec(red, gt, e_out, K):
    """[nb, 2] reduced exit vectors -> [nb, K] full (LOG_ZERO fill)."""
    gout = gt[e_out.long()]
    iK = torch.arange(K, device=red.device)
    full = torch.full((red.shape[0], K), LOG_ZERO, dtype=_F32, device=red.device)
    for c in range(GROUP):
        full = torch.where(iK[None, :] == gout[:, c, None], red[:, c, None], full)
    return full


def _scatter_ftab(ebits, gt, e_in, e_out, K):
    """Packed exit->entry bits -> [nb, K] int32 state-id composition tables.
    Rows outside the exit group get the entry group's low state; they are
    never read."""
    gin = gt[e_in.long()]  # [nb, 2]
    gout = gt[e_out.long()]
    e0 = (ebits & 1).long()  # entry index reached from exit 0
    e1 = ((ebits >> 1) & 1).long()
    val0 = torch.gather(gin, 1, e0[:, None])[:, 0]
    val1 = torch.gather(gin, 1, e1[:, None])[:, 0]
    iK = torch.arange(K, device=gin.device)
    full = gin[:, 0, None].expand(gin.shape[0], K)
    full = torch.where(iK[None, :] == gout[:, 0, None], val0[:, None], full)
    full = torch.where(iK[None, :] == gout[:, 1, None], val1[:, None], full)
    return full.to(_I32)


# ---------------------------------------------------------------------------
# Pass-level API (the "onehot" engine of viterbi_parallel.get_passes)


def pass_products(params: HmmParams, steps2, prev0=None, resets=None, pre=None):
    """Pass A: (incl, offs, total) from the reduced block products."""
    K = params.n_states
    S, gt, tab, _, pair2, e_in, e_out, nreal = _prepared(params, steps2, prev0, resets, pre)
    nb = pair2.shape[1]
    red = oh_products(_pad_pair_rows(pair2, e_out, nreal), tab.contiguous())
    red = red.T.reshape(nb, GROUP, GROUP)
    P = _scatter_products(red, gt, e_in, e_out, K)
    incl, offs = scan_block_products(P)
    return incl, offs, incl[-1]


def _pass_backpointers_impl(params: HmmParams, v_enter, steps2, prev0, resets, pre,
                            want_scores: bool):
    """Pass B through B2, or through B6 with ``want_scores``: (delta_blocks
    [nb, K], F [nb, K], blob, dmax2 [bk, nb] or None)."""
    K = params.n_states
    S, gt, tab, idtab, pair2, e_in, e_out, nreal = _prepared(
        params, steps2, prev0, resets, pre
    )
    bk_real, nb = pair2.shape
    v_red = torch.gather(v_enter, 1, gt[e_in.long()])  # [nb, 2]
    ghigh_end = gt[e_out.long(), 1]  # [nb] — exit-bit anchor conversion
    pair2p = _pad_pair_rows(pair2, e_out, nreal)
    args = (pair2p, v_red.T.to(_F32).contiguous(), tab.contiguous())
    dmax2 = None
    if want_scores:
        bp, dexit_red, ebits, dmax2 = oh_backpointers_scores(*args)
        dmax2 = dmax2[:bk_real]
    else:
        bp, dexit_red, ebits = oh_backpointers(*args)
    delta_exit = _scatter_vec(dexit_red.T, gt, e_out, K)
    F = _scatter_ftab(ebits, gt, e_in, e_out, K)
    blob = (bp, pair2p, idtab.contiguous(), ghigh_end, bk_real, nb)
    return delta_exit, F, blob, dmax2


def pass_backpointers(params: HmmParams, v_enter, steps2, prev0=None, resets=None,
                      pre=None):
    """Pass B: (delta_blocks [nb, K], F [nb, K], blob); the blob carries the
    packed pointers plus the pair stream for the backtrace."""
    delta_exit, F, blob, _ = _pass_backpointers_impl(params, v_enter, steps2, prev0,
                                                     resets, pre, want_scores=False)
    return delta_exit, F, blob


def pass_backpointers_scores(params: HmmParams, v_enter, steps2, prev0=None, resets=None,
                             pre=None):
    """:func:`pass_backpointers` through B6: also returns the per-step chain
    max dmax2 [bk, nb] (block-normalized: add the block's entering offset
    for true values), the flat batch decoder's score feed."""
    return _pass_backpointers_impl(params, v_enter, steps2, prev0, resets, pre,
                                   want_scores=True)


def pass_backtrace(blob, exits: torch.Tensor) -> torch.Tensor:
    """Pass C: -> [bk*nb] state ids in global step order."""
    bp, pair2p, idtab, ghigh_end, bk_real, nb = blob
    exit_bits = (exits.long() == ghigh_end).to(_I32)
    path2 = oh_backtrace(bp, pair2p, idtab, exit_bits)
    return path2[:bk_real].T.reshape(-1)


# ---------------------------------------------------------------------------
# Flat batched decode (one kernel launch per pass for N records)


def prepare_decode_flat(S: int, chunks: torch.Tensor, lengths: torch.Tensor,
                        block_size: int):
    """Symbol-only prep of the flat batched decode: (concat [N*T] clamped
    symbols, padded [nb*bk] step stream, resets [bk, nb] bool, bk, pre)."""
    N, T = chunks.shape
    dev = chunks.device
    obs_c = torch.where(
        torch.arange(T, device=dev)[None, :] >= lengths.to(dev)[:, None],
        S,
        torch.clamp_max(chunks.to(_I32), S),
    ).to(_I32)
    concat = obs_c.reshape(-1)
    Np = N * T
    n_steps = Np - 1
    bk = min(block_size, max(8, n_steps))
    nb = -(-n_steps // bk)
    padded = torch.cat([
        concat[1:], torch.full((nb * bk - n_steps,), S, dtype=_I32, device=dev)
    ])
    # Step r*T - 1 is the reset entering record r's position 0; entry [k, b]
    # is global step b*bk + k.
    kk = torch.arange(bk, dtype=_I32, device=dev)[:, None]
    bb = torch.arange(nb, dtype=_I32, device=dev)[None, :]
    gstep = bb * bk + kk
    resets = ((gstep + 1) % T == 0) & (gstep + 1 < Np)
    steps2 = padded.reshape(nb, bk).T
    pre = prepare_pairs(S, steps2, concat[0], resets)
    return concat, padded, resets, bk, pre


def decode_batch_flat(params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                      block_size: int = 4096, prepared=None, return_score: bool = False):
    """Decode an [N, T] batch as ONE flat stream with RESET steps.

    The records concatenate into one sequence whose step into each record's
    position 0 is a rank-one RESET matrix (_reset_rows): the chain restarts
    at the record's initial scores up to an additive constant, and the
    backpointer at the reset is the previous record's true exit argmax, so
    every kernel runs at single-stream occupancy.  Paths equal per-record
    decodes except where f32 rounding of the folded constant splits a
    near-tie (any mismatch re-scores identically in f64).  Returns paths
    [N, T] (positions >= lengths[r] carry the exit state).

    ``return_score=True`` runs the backpointer pass through B6 and also
    returns exact per-record Viterbi scores [N]: the reset constants
    telescope (a reset sets v = max(v_prev) + v0red, so the true chain max
    at record r's last position is M_r = score_r + sum of earlier scores),
    and scores are first differences of M.  Each M_r is the block-relative
    chain max there plus that block's entering offset, so a late record's
    score carries the f32 rounding of the whole stream's magnitude before
    it.  ``block_size`` is 4096 with or without scores: the port has no
    tuner table to pick another."""
    from cpgisland_tpu_torch.ops.viterbi_parallel import _block_passes, _step_tables

    S = params.n_symbols
    N, T = chunks.shape
    if T < 2:
        raise ValueError("decode_batch_flat needs records of at least 2 symbols")
    if prepared is None:
        prepared = prepare_decode_flat(S, chunks, lengths, block_size)
    concat, padded, resets, bk, pre = prepared
    if concat.shape[0] != N * T:
        raise ValueError(
            f"prepared decode stream was built for {concat.shape[0]} symbols; "
            f"this batch has {N * T}"
        )
    _, emit_ext = _step_tables(params)
    v0 = params.log_pi + emit_ext[concat[0].long()]
    dec = _block_passes(
        params, v0, padded, bk, engine="onehot", prev0=concat[0],
        resets=resets, pre=pre, want_scores=return_score,
    )
    s0 = dec.ftable[torch.argmax(dec.delta_exit)]
    full = torch.cat([s0[None], dec.path[: N * T - 1]]).reshape(N, T)
    if not return_score:
        return full
    # Record r's last position is global step (r+1)*T - 2's output.
    e = (torch.arange(N, device=full.device) + 1) * T - 2
    b = torch.div(e, bk, rounding_mode="floor")
    M = dec.dmax2[e - b * bk, b] + dec.enter_offs[b]
    return full, torch.cat([M[:1], M[1:] - M[:-1]])
