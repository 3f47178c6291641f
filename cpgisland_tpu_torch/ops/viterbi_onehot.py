"""One-hot-emission reduced Viterbi engine: the decode CUDA kernels (B1-B3,
B6 and the stacked B26-B28) and their plain PyTorch versions.

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
through B6, which also emits the per-step chain max.  The stacked decode
(:func:`decode_batch_flat_stacked`, B26-B28) runs M models of one alphabet
over one shared pair stream, one launch per pass for every member.  The
kernels (``csrc/viterbi_onehot.cu``) run one thread per lane (B1: per row
of a lane's 2x2 product up to 48 Ki lanes, or 32 Ki lanes x members; B3:
per segment of a lane's walk, the segments joined by exact bits) over the
time-major [bk, nb] streams, with the pair tables in shared memory (at
most :data:`MAX_PAIRS` rows: 16 symbols with record resets); each wrapper
below launches its kernel for a CUDA tensor, takes the plain PyTorch
version for a CPU tensor, and raises otherwise.  Max-plus is adds and maxes
only, so kernel and plain version agree bit for bit.

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
# The kernels' shared pair tables: S*S real pairs, S resets and S PAD
# carries for alphabets of up to MAX_SYMBOLS symbols.
MAX_SYMBOLS = 16
MAX_PAIRS = MAX_SYMBOLS * MAX_SYMBOLS + 2 * MAX_SYMBOLS
# The segment length, in packed words (8 steps a word), B3 / B28's wrappers
# pass to the kernel: 0 takes the kernel's own (csrc/viterbi_onehot.cu
# BT_SEG, doubled on many lanes), which the kernel lengthens where a lane would need more segments
# than a block holds.  The card tests set other lengths.
BT_SEG_WORDS = 0

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


def _member_tables(params: HmmParams, resets):
    """(gt, tab, idtab) of one model; with ``resets`` its RESET rows are
    spliced in at [S*S, S*S + S), ahead of the PAD carries."""
    S = params.n_symbols
    gt = _groups(params)
    tab, idtab = _pair_table(params, gt)
    if resets is not None:
        rrows, rgt = _reset_rows(params, gt)
        tab = torch.cat([tab[: S * S], rrows, tab[S * S :]], dim=0)
        idtab = torch.cat([idtab[: S * S], rgt, idtab[S * S :]], dim=0)
    return gt, tab, idtab


def _prepared(params: HmmParams, steps2, prev0, resets=None, pre=None):
    """Tables + pair stream for the passes (``pre``: a prepare_pairs tuple
    built with the SAME ``resets`` mask)."""
    S = params.n_symbols
    if pre is None:
        pre = prepare_pairs(S, steps2, prev0, resets)
    pair2, e_in, e_out, nreal = pre
    if resets is not None and nreal != S * S + S:
        raise ValueError(
            "prepared pair stream was built without the resets mask "
            "this call passes (nreal mismatch)"
        )
    if resets is None and nreal != S * S:
        raise ValueError(
            "prepared pair stream carries reset renumbering but this call "
            "passes no resets mask"
        )
    gt, tab, idtab = _member_tables(params, resets)
    return S, gt, tab, idtab, pair2, e_in, e_out, nreal


def stacked_prepared(params_list, steps2, prev0, resets=None, pre=None):
    """The stacked twin of :func:`_prepared`: ONE shared symbol-only pair
    stream plus per-member tables.  Returns (S, gts, tabs, idtabs, pair2,
    e_in, e_out, nreal) with gts / tabs / idtabs per-member lists; with
    ``resets`` each member's reset rows are spliced into its own table
    (every member shares the reset MASK and restarts into its own initial
    scores)."""
    if not params_list:
        raise ValueError("a stacked decode needs at least one member")
    S = params_list[0].n_symbols
    if any(p.n_symbols != S for p in params_list):
        raise ValueError(
            "stacked members must share one alphabet (pair stream); got "
            f"n_symbols {[int(p.n_symbols) for p in params_list]}"
        )
    if pre is None:
        pre = prepare_pairs(S, steps2, prev0, resets)
    pair2, e_in, e_out, nreal = pre
    want = S * S + (S if resets is not None else 0)
    if nreal != want:
        raise ValueError(
            "prepared pair stream's reset renumbering does not match this "
            f"call (nreal {nreal} != {want})"
        )
    gts, tabs, idtabs = zip(*(_member_tables(p, resets) for p in params_list))
    return S, list(gts), list(tabs), list(idtabs), pair2, e_in, e_out, nreal


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
# The kernels: plain PyTorch versions and the wrappers that launch the CUDA
# kernels.  Shapes are the kernels' own: pair2 [bk, nb] int32 with bk a
# multiple of ROW_TILE, tab [nP, 4] f32 (every pair's 2x2 step matrix,
# identity rows included), idtab [nP, 2] int32.  The stacked kernels (B26-
# B28) take every per-member operand with a leading member axis: tabs
# [M, nP, 4], idtabs [M, nP, 2], v_red [M, 2, nb], exit bits [M, nb].  Each
# plain version carries the member axis through one step loop, as the JAX
# package's stacked XLA twins do; the single-model plain versions are its
# M = 1 case (every operation is elementwise across members and lanes, so
# a member's values do not depend on the others).


def oh_products_stacked_plain(pair2: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """B26, plain version: each member's 2x2 max-plus product of each
    lane's pair-selected step matrices -> [M, 4, nb] (rows C00, C01, C10,
    C11).  Mirrors ``_xla_products_stacked`` (per member ``_xla_products``)
    op for op; selection is an exact gather."""
    M = tabs.shape[0]
    nb = pair2.shape[1]
    T = tabs[:, pair2.long()]  # [M, bk, nb, 4]
    c00 = torch.zeros((M, nb), dtype=_F32, device=pair2.device)
    c01 = torch.full((M, nb), LOG_ZERO, dtype=_F32, device=pair2.device)
    c10 = c01.clone()
    c11 = c00.clone()
    for k in range(pair2.shape[0]):
        t = T[:, k]
        n00 = torch.maximum(c00 + t[..., 0], c01 + t[..., 2])
        n01 = torch.maximum(c00 + t[..., 1], c01 + t[..., 3])
        n10 = torch.maximum(c10 + t[..., 0], c11 + t[..., 2])
        n11 = torch.maximum(c10 + t[..., 1], c11 + t[..., 3])
        c00, c01, c10, c11 = n00, n01, n10, n11
    return torch.stack([c00, c01, c10, c11], dim=1)


def oh_products_plain(pair2: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Pass A, plain version: [4, nb] block products.  Mirrors the JAX
    package's ``_xla_products``."""
    return oh_products_stacked_plain(pair2, tab[None])[0]


def _pack_words(bp2: torch.Tensor) -> torch.Tensor:
    """[..., bk, nb] 2-bit rows (bk % 8 == 0) -> [..., bk/8, nb] int32
    words, step r of a word at bits 2r..2r+1."""
    *lead, bk, nb = bp2.shape
    shifts = 2 * torch.arange(ROW_TILE, dtype=_I32, device=bp2.device)[:, None]
    rows = bp2.reshape(*lead, bk // ROW_TILE, ROW_TILE, nb) << shifts
    return rows.sum(dim=-2, dtype=_I32)  # disjoint bits: sum == or


def _unpack_words(bp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_words`: [..., bk/8, nb] words -> [..., bk,
    nb] rows."""
    *lead, nw, nb = bp.shape
    shifts = 2 * torch.arange(ROW_TILE, dtype=_I32, device=bp.device)[:, None]
    return ((bp[..., :, None, :] >> shifts) & 3).reshape(*lead, nw * ROW_TILE, nb)


def _backpointers_chain(pair2: torch.Tensor, v_red: torch.Tensor, tabs: torch.Tensor,
                        want_dmax: bool):
    """The reduced delta recursion every plain pass-B version shares (the
    counterpart of the kernels' ``WANT_DMAX`` template), over v_red
    [M, 2, nb] and tabs [M, nP, 4]: (bp [M, bk/8, nb], dexit [M, 2, nb],
    ebits [M, nb], dmax2 [M, bk, nb] or None).  With ``want_dmax`` each
    step also stores max(d0, d1), off the chain, so the first three
    outputs do not change."""
    M = tabs.shape[0]
    bk, nb = pair2.shape
    T = tabs[:, pair2.long()]  # [M, bk, nb, 4]
    d0, d1 = v_red[:, 0].clone(), v_red[:, 1].clone()
    E = torch.full((M, nb), 0b10, dtype=_I32, device=pair2.device)
    rows = []
    dmax2 = torch.empty((M, bk, nb), dtype=_F32, device=pair2.device) if want_dmax else None
    for k in range(bk):
        t = T[:, k]
        a0 = d0 + t[..., 0]
        a1 = d1 + t[..., 2]
        b0 = d0 + t[..., 1]
        b1 = d1 + t[..., 3]
        bp0 = (a1 > a0).to(_I32)
        bp1 = (b1 > b0).to(_I32)
        E = ((E >> bp0) & 1) | (((E >> bp1) & 1) << 1)
        d0 = torch.maximum(a0, a1)
        d1 = torch.maximum(b0, b1)
        if want_dmax:
            dmax2[:, k] = torch.maximum(d0, d1)
        rows.append(bp0 | (bp1 << 1))
    return _pack_words(torch.stack(rows, dim=1)), torch.stack([d0, d1], dim=1), E, dmax2


def oh_backpointers_stacked_plain(pair2: torch.Tensor, v_red: torch.Tensor,
                                  tabs: torch.Tensor):
    """B27, plain version: every member's reduced delta recursion from its
    entering vectors -> (bp [M, bk/8, nb], dexit [M, 2, nb], ebits
    [M, nb]).  Mirrors ``_xla_backpointers_stacked`` without scores."""
    return _backpointers_chain(pair2, v_red, tabs, want_dmax=False)[:3]


def oh_backpointers_stacked_scores_plain(pair2: torch.Tensor, v_red: torch.Tensor,
                                         tabs: torch.Tensor):
    """B27's scores arm, plain version: B27's outputs plus each member's
    per-step chain max dmax2 [M, bk, nb].  Mirrors
    ``_xla_backpointers_stacked(want_scores=True)``."""
    return _backpointers_chain(pair2, v_red, tabs, want_dmax=True)


def oh_backpointers_plain(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Pass B, plain version: the reduced delta recursion from the entering
    vectors v_red [2, nb].  Returns (bp [bk/8, nb] int32 packed 2-bit
    backpointers, dexit [2, nb] f32, ebits [nb] int32 exit -> entry bits).
    Strict ``>`` keeps argmax first-max tie-breaking.  Mirrors
    ``_xla_backpointers``."""
    out = _backpointers_chain(pair2, v_red[None], tab[None], want_dmax=False)
    return tuple(x[0] for x in out[:3])


def oh_backpointers_scores_plain(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Pass B with score threading, plain version: (bp, dexit, ebits, dmax2
    [bk, nb]), dmax2 the running chain max max(d0, d1) after each step,
    relative to the block's normalized entering vector.  Mirrors
    ``_xla_backpointers_scores``."""
    out = _backpointers_chain(pair2, v_red[None], tab[None], want_dmax=True)
    return tuple(x[0] for x in out)


def oh_backtrace_stacked_plain(bp: torch.Tensor, pair2: torch.Tensor, idtabs: torch.Tensor,
                               exit_bits: torch.Tensor) -> torch.Tensor:
    """B28, plain version: each member walks its 2-bit backpointers from
    its exit bits, emitting full state ids through its pair -> exit-group
    table -> path [M, bk, nb] int32.  Mirrors ``_xla_backtrace_bits_stacked``
    with the ids resolved per member."""
    M = idtabs.shape[0]
    bk, nb = pair2.shape
    rows = _unpack_words(bp)
    ids = idtabs[:, pair2.long()]  # [M, bk, nb, 2]
    path = torch.empty((M, bk, nb), dtype=_I32, device=pair2.device)
    bit = exit_bits.to(_I32)
    for k in range(bk - 1, -1, -1):
        path[:, k] = torch.where(bit == 0, ids[:, k, :, 0], ids[:, k, :, 1])
        bit = (rows[:, k] >> bit) & 1
    return path


def oh_backtrace_stacked_sub_plain(bp: torch.Tensor, pair2: torch.Tensor, idtabs: torch.Tensor,
                                   exit_bits: torch.Tensor, seg: int):
    """B28's walk as the kernels split it, plain version (for the tests):
    each lane's nw = bk/8 words in G = ceil(nw / seg) segments of ``seg``
    words, [s seg, min((s + 1) seg, nw)).  Each segment's map (the bit
    below its first step from the bit at its last, walked from both bits)
    is computed without the bit that enters it; the exit bit goes through
    the maps of the segments above to each segment's last step, and each
    segment then walks as :func:`oh_backtrace_stacked_plain` does.  Returns
    path [M, bk, nb], equal to that one walk's."""
    M = idtabs.shape[0]
    bk, nb = pair2.shape
    nw = bk // ROW_TILE
    G = max(1, -(-nw // seg))
    rows = _unpack_words(bp)
    ids = idtabs[:, pair2.long()]  # [M, bk, nb, 2]
    bounds = [(s * seg * ROW_TILE, min((s + 1) * seg, nw) * ROW_TILE) for s in range(G)]
    maps = []
    for k_lo, k_hi in bounds:
        f = torch.stack([torch.zeros((M, nb), dtype=_I32, device=pair2.device),
                         torch.ones((M, nb), dtype=_I32, device=pair2.device)])
        for k in range(k_hi - 1, k_lo - 1, -1):
            f = (rows[None, :, k] >> f) & 1
        maps.append(f)
    # The bit at each segment's last step: the exit bit through the maps of
    # the segments above it.
    tops, bit = [None] * G, exit_bits.to(_I32)
    for s in range(G - 1, -1, -1):
        tops[s] = bit
        bit = torch.where(bit == 0, maps[s][0], maps[s][1])
    path = torch.empty((M, bk, nb), dtype=_I32, device=pair2.device)
    for (k_lo, k_hi), bit in zip(bounds, tops):
        for k in range(k_hi - 1, k_lo - 1, -1):
            path[:, k] = torch.where(bit == 0, ids[:, k, :, 0], ids[:, k, :, 1])
            bit = (rows[:, k] >> bit) & 1
    return path


def oh_backtrace_plain(bp: torch.Tensor, pair2: torch.Tensor, idtab: torch.Tensor,
                       exit_bits: torch.Tensor) -> torch.Tensor:
    """Pass C, plain version: walk the 2-bit backpointers from the exit
    bits, emitting full state ids through the pair -> exit-group table.
    Returns path [bk, nb] int32.  Mirrors ``_xla_backtrace``."""
    return oh_backtrace_stacked_plain(bp[None], pair2, idtab[None], exit_bits[None])[0]


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


def _table_rows(name: str, t: torch.Tensor, width: int, stacked: bool):
    """(M, nP) of a pair table ([nP, width], or [M, nP, width] stacked),
    refusing one the kernels' shared tables cannot hold."""
    if t.dim() != (3 if stacked else 2) or t.shape[-1] != width:
        want = f"[M, nP, {width}]" if stacked else f"[nP, {width}]"
        raise ValueError(f"{name}: expected {want}, got {tuple(t.shape)}")
    M, nP = (t.shape[0], t.shape[1]) if stacked else (1, t.shape[0])
    if M < 1:
        raise ValueError(f"{name}: a stacked launch needs at least one member")
    if not 1 <= nP <= MAX_PAIRS:
        raise ValueError(
            f"{name}: a pair table of {nP} rows; the decode kernels take at most "
            f"{MAX_PAIRS} ({MAX_SYMBOLS} symbols with record resets)"
        )
    return M, nP


def _launch_ints(bk: int, nb: int, nP: int, M: int, stacked: bool) -> dict:
    return {"bk": bk, "nb": nb, "nP": nP} | ({"M": M} if stacked else {})


def _products_launch(name: str, pair2, tab, stacked: bool):
    """B1 (single) or B26 (stacked): check, then the plain version on the
    CPU or the kernel on the card."""
    _check_stream(pair2, (tab,))
    bk, nb = pair2.shape
    M, nP = _table_rows("tab", tab, 4, stacked)
    lead = (M,) if stacked else ()
    _check("pair2", pair2, _I32, (bk, nb))
    _check("tab", tab, _F32, lead + (nP, 4))
    if pair2.device.type == "cpu":
        out = oh_products_stacked_plain(pair2, tab.reshape(M, nP, 4))
        return out if stacked else out[0]
    out = torch.empty(lead + (4, nb), dtype=_F32, device=pair2.device)
    _kernels.launch(name, pair2, tab, out, **_launch_ints(bk, nb, nP, M, stacked))
    return out


def oh_products(pair2: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Kernel B1 (replaces the JAX package's ``_oh_products_kernel``):
    [bk, nb] pairs + [nP, 4] table -> [4, nb] block products."""
    return _products_launch("oh_products", pair2, tab, False)


def oh_products_stacked(pair2: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """Kernel B26 (replaces ``_oh_products_stacked_kernel``): [bk, nb]
    pairs + [M, nP, 4] tables -> [M, 4, nb], member m's block products
    (its C00, C01, C10, C11)."""
    return _products_launch("oh_products_stacked", pair2, tabs, True)


def _backpointers_launch(name: str, pair2, v_red, tab, stacked: bool, want_dmax: bool):
    """B2 / B6 (single) or B27 / its scores arm (stacked): check, then the
    plain version on the CPU or the kernel on the card."""
    _check_stream(pair2, (v_red, tab))
    bk, nb = pair2.shape
    M, nP = _table_rows("tab", tab, 4, stacked)
    lead = (M,) if stacked else ()
    _check("pair2", pair2, _I32, (bk, nb))
    _check("v_red", v_red, _F32, lead + (GROUP, nb))
    _check("tab", tab, _F32, lead + (nP, 4))
    if pair2.device.type == "cpu":
        out = _backpointers_chain(pair2, v_red.reshape(M, GROUP, nb),
                                  tab.reshape(M, nP, 4), want_dmax)
        out = out if want_dmax else out[:3]
        return out if stacked else tuple(x[0] for x in out)
    dev = pair2.device
    outs = [torch.empty(lead + (bk // ROW_TILE, nb), dtype=_I32, device=dev),
            torch.empty(lead + (GROUP, nb), dtype=_F32, device=dev),
            torch.empty(lead + (nb,), dtype=_I32, device=dev)]
    if want_dmax:
        outs.append(torch.empty(lead + (bk, nb), dtype=_F32, device=dev))
    _kernels.launch(name, pair2, v_red, tab, *outs, **_launch_ints(bk, nb, nP, M, stacked))
    return tuple(outs)


def oh_backpointers(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Kernel B2 (replaces ``_oh_backpointers_kernel``): -> (bp [bk/8, nb]
    int32, dexit [2, nb] f32, ebits [nb] int32)."""
    return _backpointers_launch("oh_backpointers", pair2, v_red, tab, False, False)


def oh_backpointers_scores(pair2: torch.Tensor, v_red: torch.Tensor, tab: torch.Tensor):
    """Kernel B6 (replaces ``_oh_backpointers_score_kernel``): B2's outputs
    plus dmax2 [bk, nb] f32, the per-step chain max -> (bp, dexit, ebits,
    dmax2)."""
    return _backpointers_launch("oh_backpointers_scores", pair2, v_red, tab, False, True)


def oh_backpointers_stacked(pair2: torch.Tensor, v_red: torch.Tensor, tabs: torch.Tensor):
    """Kernel B27 (replaces ``_oh_backpointers_stacked_kernel``): v_red
    [M, 2, nb], tabs [M, nP, 4] -> (bp [M, bk/8, nb] int32, dexit [M, 2, nb]
    f32, ebits [M, nb] int32), member m's equal to B2 on its operands."""
    return _backpointers_launch("oh_backpointers_stacked", pair2, v_red, tabs, True, False)


def oh_backpointers_stacked_scores(pair2: torch.Tensor, v_red: torch.Tensor,
                                   tabs: torch.Tensor):
    """Kernel B27 with ``want_scores`` (B6 for M members): B27's outputs
    plus dmax2 [M, bk, nb] f32 -> (bp, dexit, ebits, dmax2)."""
    return _backpointers_launch("oh_backpointers_stacked_scores", pair2, v_red, tabs,
                                True, True)


def _backtrace_launch(name: str, bp, pair2, idtab, exit_bits, stacked: bool):
    """B3 (single) or B28 (stacked): check, then the plain version on the
    CPU or the kernel on the card."""
    _check_stream(pair2, (bp, idtab, exit_bits))
    bk, nb = pair2.shape
    M, nP = _table_rows("idtab", idtab, GROUP, stacked)
    lead = (M,) if stacked else ()
    _check("bp", bp, _I32, lead + (bk // ROW_TILE, nb))
    _check("pair2", pair2, _I32, (bk, nb))
    _check("idtab", idtab, _I32, lead + (nP, GROUP))
    _check("exit_bits", exit_bits, _I32, lead + (nb,))
    if pair2.device.type == "cpu":
        path = oh_backtrace_stacked_plain(bp.reshape(M, bk // ROW_TILE, nb), pair2,
                                          idtab.reshape(M, nP, GROUP), exit_bits.reshape(M, nb))
        return path if stacked else path[0]
    path = torch.empty(lead + (bk, nb), dtype=_I32, device=pair2.device)
    _kernels.launch(name, bp, pair2, idtab, exit_bits, path,
                    seg=BT_SEG_WORDS,
                    **_launch_ints(bk, nb, nP, M, stacked))
    return path


def oh_backtrace(bp: torch.Tensor, pair2: torch.Tensor, idtab: torch.Tensor,
                 exit_bits: torch.Tensor) -> torch.Tensor:
    """Kernel B3 (replaces ``_oh_backtrace_kernel``): -> path [bk, nb] int32
    state ids."""
    return _backtrace_launch("oh_backtrace", bp, pair2, idtab, exit_bits, False)


def oh_backtrace_stacked(bp: torch.Tensor, pair2: torch.Tensor, idtabs: torch.Tensor,
                         exit_bits: torch.Tensor) -> torch.Tensor:
    """Kernel B28 (replaces ``_oh_backtrace_stacked_kernel``): bp
    [M, bk/8, nb], idtabs [M, nP, 2], exit_bits [M, nb] -> path [M, bk, nb]
    int32, member m's equal to B3 on its operands."""
    return _backtrace_launch("oh_backtrace_stacked", bp, pair2, idtabs, exit_bits, True)

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
# Stacked passes: M members' reduced chains over ONE shared pair stream, one
# launch per pass (B26-B28).  Member m's results equal its own single-model
# pass over the same ``steps2`` bit for bit.


def pass_products_stacked(params_list, steps2, prev0=None, resets=None, pre=None):
    """Stacked :func:`pass_products` through B26: a per-member list of
    (incl, offs, total)."""
    _, gts, tabs, _, pair2, e_in, e_out, nreal = stacked_prepared(
        params_list, steps2, prev0, resets, pre
    )
    nb = pair2.shape[1]
    reds = oh_products_stacked(_pad_pair_rows(pair2, e_out, nreal), torch.stack(tabs))
    out = []
    for m, params in enumerate(params_list):
        red = reds[m].T.reshape(nb, GROUP, GROUP)
        incl, offs = scan_block_products(
            _scatter_products(red, gts[m], e_in, e_out, params.n_states))
        out.append((incl, offs, incl[-1]))
    return out


def pass_backpointers_stacked(params_list, v_enters, steps2, prev0=None, resets=None,
                              pre=None, want_scores: bool = False):
    """Stacked :func:`pass_backpointers` (through B27, or its scores arm
    with ``want_scores``): ``v_enters`` is the per-member [nb, K] list of
    entering vectors.  Returns a per-member list of (delta_exit, F, dmax2
    [bk, nb] or None) and ONE blob for :func:`pass_backtrace_stacked`."""
    _, gts, tabs, idtabs, pair2, e_in, e_out, nreal = stacked_prepared(
        params_list, steps2, prev0, resets, pre
    )
    bk_real, nb = pair2.shape
    v_red = torch.stack([torch.gather(v, 1, gt[e_in.long()]).T.to(_F32)
                         for v, gt in zip(v_enters, gts)])  # [M, 2, nb]
    pair2p = _pad_pair_rows(pair2, e_out, nreal)
    args = (pair2p, v_red.contiguous(), torch.stack(tabs))
    if want_scores:
        bp, dexit_red, ebits, dmax2 = oh_backpointers_stacked_scores(*args)
    else:
        bp, dexit_red, ebits = oh_backpointers_stacked(*args)
    outs = []
    for m, params in enumerate(params_list):
        K = params.n_states
        outs.append((
            _scatter_vec(dexit_red[m].T, gts[m], e_out, K),
            _scatter_ftab(ebits[m], gts[m], e_in, e_out, K),
            dmax2[m, :bk_real] if want_scores else None,
        ))
    ghigh_ends = [gt[e_out.long(), 1] for gt in gts]  # per-member exit-bit anchors
    return outs, (bp, pair2p, torch.stack(idtabs), ghigh_ends, bk_real, nb)


def pass_backtrace_stacked(blob, exits_list) -> list:
    """Stacked :func:`pass_backtrace` through B28: ``exits_list`` holds each
    member's [nb] exit-state anchors.  Returns per-member [bk*nb] paths."""
    bp, pair2p, idtabs, ghigh_ends, bk_real, _ = blob
    exit_bits = torch.stack([(exits.long() == g).to(_I32)
                             for exits, g in zip(exits_list, ghigh_ends)])
    path2 = oh_backtrace_stacked(bp, pair2p, idtabs, exit_bits)
    return [p[:bk_real].T.reshape(-1) for p in path2]


def _block_passes_stacked(params_list, v0s, padded, bk: int, resets, pre,
                          want_scores: bool = False) -> list:
    """The stacked twin of viterbi_parallel._block_passes (onehot engine):
    ONE launch per pass for every member; the model-sized stitching loops
    over members.  Member m's BlockDecode equals what ``_block_passes(...,
    engine="onehot")`` returns for it alone."""
    from cpgisland_tpu_torch.ops.viterbi_parallel import (
        BlockDecode,
        _enter_vectors,
        _suffix_compositions,
    )

    nb = padded.shape[0] // bk
    steps2 = padded.reshape(nb, bk).T
    prods = pass_products_stacked(params_list, steps2, None, resets=resets, pre=pre)
    v_enters, enter_offs = zip(*(_enter_vectors(v0, incl, offs)
                                 for v0, (incl, offs, _) in zip(v0s, prods)))
    bps, blob = pass_backpointers_stacked(params_list, v_enters, steps2, None, resets=resets,
                                          pre=pre, want_scores=want_scores)
    exits_list, Gsufs = [], []
    for delta_blocks, F, _ in bps:
        s_exit = torch.argmax(delta_blocks[-1]).to(torch.int32)
        Gsuf = _suffix_compositions(F)
        exits_list.append(torch.cat([Gsuf[1:, :][:, s_exit.long()], s_exit[None]]))
        Gsufs.append(Gsuf)
    paths = pass_backtrace_stacked(blob, exits_list)
    return [
        BlockDecode(
            path=path, delta_exit=delta_blocks[-1], total=total, ftable=Gsuf[0],
            score_offset=offs[-1], enter_offs=offs if want_scores else None, dmax2=dmax2,
        )
        for path, (delta_blocks, _, dmax2), (_, _, total), Gsuf, offs
        in zip(paths, bps, prods, Gsufs, enter_offs)
    ]


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
    return _flat_result(dec, N, T, bk, return_score)


def _flat_result(dec, N: int, T: int, bk: int, return_score: bool):
    """A flat decode's paths [N, T] (and scores [N]) from its BlockDecode."""
    s0 = dec.ftable[torch.argmax(dec.delta_exit)]
    full = torch.cat([s0[None], dec.path[: N * T - 1]]).reshape(N, T)
    if not return_score:
        return full
    # Record r's last position is global step (r+1)*T - 2's output.
    e = (torch.arange(N, device=full.device) + 1) * T - 2
    b = torch.div(e, bk, rounding_mode="floor")
    M = dec.dmax2[e - b * bk, b] + dec.enter_offs[b]
    return full, torch.cat([M[:1], M[1:] - M[:-1]])


def decode_batch_flat_stacked(params_list, chunks: torch.Tensor, lengths: torch.Tensor,
                              block_size=None, prepared=None, return_score: bool = False):
    """Decode ONE [N, T] batch under M models of one alphabet in ONE
    stacked launch set: paths [M, N, T], or (paths, scores [M, N]).

    The multi-model twin of :func:`decode_batch_flat`: the flat reset-step
    stream holds only symbols, so every member shares it and its prep, and
    each pass runs once for all members (B26, B27 or its scores arm, B28).
    Member m's paths and scores equal ``decode_batch_flat(params_list[m],
    chunks, lengths, block_size)`` bit for bit.  ``block_size=None`` means
    the prep's block when ``prepared`` is given, else 4096 (the port has no
    tuner table); a prep built for another batch or block raises."""
    from cpgisland_tpu_torch.ops.viterbi_parallel import DEFAULT_BLOCK, _step_tables

    if not params_list:
        raise ValueError("decode_batch_flat_stacked needs at least one member")
    S = params_list[0].n_symbols
    N, T = chunks.shape
    if T < 2:
        raise ValueError("decode_batch_flat_stacked needs records of at least 2 symbols")
    if block_size is None:
        block_size = prepared[3] if prepared is not None else DEFAULT_BLOCK
    block_size = int(block_size)
    if prepared is None:
        prepared = prepare_decode_flat(S, chunks, lengths, block_size)
    concat, padded, resets, bk, pre = prepared
    n_steps = N * T - 1
    want_bk = min(block_size, max(8, n_steps))
    if concat.shape[0] != N * T or bk != want_bk:
        raise ValueError(
            f"prepared decode stream was built for {concat.shape[0]} symbols / "
            f"bk={bk}; this call needs {N * T} symbols / bk={want_bk} — rebuild it "
            "with prepare_decode_flat"
        )
    v0s = [p.log_pi + _step_tables(p)[1][concat[0].long()] for p in params_list]
    decs = _block_passes_stacked(params_list, v0s, padded, bk, resets, pre,
                                 want_scores=return_score)
    outs = [_flat_result(dec, N, T, bk, return_score) for dec in decs]
    if not return_score:
        return torch.stack(outs)
    return torch.stack([p for p, _ in outs]), torch.stack([s for _, s in outs])
