"""One-hot-emission reduced forward-backward: the CUDA kernels and their
plain PyTorch versions.

Counterpart of ``cpgisland_tpu/ops/fb_onehot.py``: the fused two-pass
arm, the split arm and the one-pass arm (the chunked and whole-sequence
E-steps and the posterior).  For one-hot-emission models (the
flagship 8-state preset) the alpha/beta vectors are exactly zero outside
the 2-state group of the position's symbol, so the K-state recurrences
reduce to 2-state recurrences whose per-step 2x2 matrix is A (times the
emission probability) between the previous symbol's group and the current
one's — the per-pair table :func:`prob_pair_table`.

- B7 :func:`oh_prod` (replaces ``_oh_prod_kernel``): each lane's 2x2
  (+, x) product of its pair-selected step matrices, renormalized by its
  own total — the lane transfer operators whose directions make the
  whole-sequence boundary messages exact.  Each lane runs as
  :func:`prod_sublanes` sub-lanes whose products (renormalized every 8
  steps, the TPU kernel's cadence) compose in order.  The plain version
  :func:`oh_prod_plain` is, in one sub-lane, the twin of
  ``_xla_products_prob`` (one renormalizing division per step) and, in
  G > 1, the kernel's two phases op for op (:func:`_prod_sublanes_plain`),
  whose directions equal the twin's in exact arithmetic.  The kernel
  equals it bit for bit.
- B4 :func:`oh_fwdbwd` (replaces ``_oh_fwdbwd_kernel``): the forward
  chain with deferred Rabiner scaling and the self-normalized backward
  chain, independent of each other, in one launch, each lane cut into
  :func:`sublanes` sub-lanes joined by exact boundary messages (both
  chains are degree 0 in the vector they carry).  The plain version
  :func:`oh_fwdbwd_plain` is, in one sub-lane, the twin of
  ``_xla_fwdbwd_onehot`` (the same f32 operations in the same order, the
  row select an exact gather) and, in G > 1, the kernel's three phases op
  for op (:func:`_fwdbwd_sublanes_plain`), equal to the twin in exact
  arithmetic.  The kernel turns FMA contraction off, so it equals the
  plain version bit for bit.
- B8 :func:`oh_fwdbwd_mat` (replaces ``_oh_fwdbwd_mat_kernel``): the
  one-pass arm.  Both chains carried as 2x2 matrices from the identity,
  so it needs no entry vector and runs before the boundary messages
  exist; :func:`run_fb_mat_onehot` takes the lane products from its
  epilogue, :func:`contract_mat_streams` applies the entry directions and
  :func:`mat_loglik_lanes` telescopes the loglik.  The plain version
  :func:`oh_fwdbwd_mat_plain` is the twin of ``_xla_fwdbwd_mat_onehot``;
  the kernel equals it bit for bit.
- B5 :func:`oh_seq_stats` (replaces ``_oh_seq_stats_kernel``): the
  z-normalized counts — each pair's xi divided by its own total, so any
  per-position scale of the betas cancels — giving dense ``macc [K*K]``,
  reduced ``emit [2S]`` and the loglik per lane.  The plain version
  :func:`oh_seq_stats_plain` is the twin of ``_xla_znorm_stats``; the
  kernel sums each lane in segments of :func:`stats_segment_t` steps (a
  function of the shape, not of the layout's t-tile), so the two sum over
  time in different orders and agree within a tolerance.

The split arm (``fused=False``, the JAX package's A/B baseline) runs the
two chains in separate launches, the backward with true Rabiner scaling:
B9 :func:`oh_fwd` (replaces ``_oh_fwd_kernel``; B4's forward in B4's
:func:`sublanes`, equal to its alphas bit for bit), B10 :func:`oh_bwd`
(``_oh_bwd_kernel``: the betas scaled by 1 / c_{t+1} from a ``cs_next``
stream, in :func:`split_bwd_sublanes` sub-lanes joined by messages that
carry the betas' magnitude), B11 :func:`oh_bwd_conf`
(``_oh_bwd_conf_kernel``: B10 in B10's sub-lanes emitting the island
confidence, the betas never stored) and B12 :func:`oh_stats`
(``_oh_stats_kernel``: the chunked counts, degree 1 in those cs-scaled
betas, behind the ``betas_scale`` guard of :func:`run_stats_onehot`).
B9-B11 equal their plain versions bit for bit; in one sub-lane those are
the twins ``_xla_fwd_onehot``, ``_xla_bwd_onehot`` and the off-TPU conf
branch of the runner op for op, in G > 1 the kernels' phases
(:func:`_fwd_sublanes_plain`, :func:`_split_bwd_sublanes_plain`), equal
to the twins in exact arithmetic.  B12 sums in another order than its
plain version (the interpret branch of ``run_stats_onehot``) and agrees
within a tolerance.

The stacked half runs M models of one alphabet over ONE shared pair
stream in one launch (the members of a comparison, a family trained in
lockstep): B21 :func:`oh_prod_stacked` (replaces ``_oh_prod_stacked_kernel``),
B24 :func:`oh_fwdbwd_stacked` (``_oh_fwdbwd_stacked_kernel``), B25
:func:`oh_seq_stats_stacked` (``_oh_seq_stats_stacked_kernel``) and the
split arm's B22 :func:`oh_fwd_stacked` (``_oh_fwd_stacked_kernel``) and B23
:func:`oh_bwd_stacked` (``_oh_bwd_stacked_kernel``).  Stacked
operands are member-major (``[M, ...]``), so member m's slice is a
contiguous single-model operand; each member's arithmetic is the
single-model kernel's, so its outputs equal a single-model launch bit for
bit.  Their plain versions carry the member axis through one step loop
(B25's, like the JAX twin, runs the single-model plain version per member).

Each wrapper takes the plain version for a CPU tensor, launches its kernel
(``csrc/fb_onehot.cu``) for a CUDA tensor, and raises otherwise.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops.viterbi_onehot import (
    GROUP,
    _check,
    _groups,
    _scatter_products,
    pair_stream,
)

_I32 = torch.int32
_F32 = torch.float32

PROB_IDENT = (1.0, 0.0, 0.0, 1.0)  # the (+, x) identity matrix entries
# Largest alphabet the kernels take: their pair tables live in shared memory.
MAX_SYMBOLS = 16
# B4 / B24's sub-lanes: a lane of Tp steps runs as Tp // SUBLANE_T sub-lanes
# (at least 1, at most MAX_SUBLANES, the kernel's csrc SUB_LANES_MAX) joined
# by exact boundary messages (:func:`sublanes`).
SUBLANE_T = 4096
MAX_SUBLANES = 32
# B7 / B21's sub-lanes (:func:`prod_sublanes`): lanes of PROD_SUBLANES_FROM
# steps or more run as sub-lanes of PROD_SUBLANE_T steps (at most
# MAX_SUBLANES), shorter lanes as one chain.
PROD_SUBLANE_T = 512
PROD_SUBLANES_FROM = 8192
# B5 / B25 / B12's segments (:func:`stats_segment_t`): each lane's steps split
# into segments of STATS_SEGMENT_T steps (at most the lane), one thread each.
STATS_SEGMENT_T = 512


def prob_pair_table(params: HmmParams, gt: torch.Tensor) -> torch.Tensor:
    """Probability-space pair table [S*S, 4]: row p = s_prev * S + s_cur
    holds [T00, T01, T10, T11] with T[a, c] = A[gt[s_prev, a], gt[s_cur, c]]
    * B[gt[s_cur, c], s_cur]."""
    S = params.n_symbols
    A = params.A.to(_F32)
    B = params.B.to(_F32)
    A_red = A[gt[:, :, None, None], gt[None, None, :, :]]  # [S, 2, S, 2]
    B_red = B[gt, torch.arange(S, device=gt.device)[:, None]]  # [S, 2]
    M = A_red * B_red[None, None, :, :]
    return M.permute(0, 2, 1, 3).reshape(S * S, 4).to(_F32)


def prob_tab_ext(params: HmmParams, gt: torch.Tensor) -> torch.Tensor:
    """[S*S + 1, 4] pair table with the identity as its last row: every
    PAD pair (p >= S*S) is clamped onto that row."""
    # Built on the device (no host copy, which would stall the stream).
    ident = torch.eye(GROUP, dtype=_F32, device=gt.device).reshape(1, 4)  # PROB_IDENT
    return torch.cat([prob_pair_table(params, gt), ident], dim=0).contiguous()


def decode_esym(pair2: torch.Tensor, S: int) -> torch.Tensor:
    """Per-position emitted symbol (PADs forward-filled) from pair indices:
    p < S*S encodes (prev, cur) with cur = p mod S; p >= S*S is a PAD
    carrying symbol p - S*S."""
    cur = pair2 - torch.div(pair2, S, rounding_mode="floor") * S
    return torch.where(pair2 < S * S, cur, pair2 - S * S).to(_I32)


def scatter_streams(x2: torch.Tensor, gt: torch.Tensor, esym2: torch.Tensor,
                    K: int) -> torch.Tensor:
    """[Tp, 2, NL] reduced streams -> [Tp, K, NL] dense (zero fill) — exact
    for every consumer (out-of-group entries are exact zeros)."""
    el = esym2.long()
    glow = gt[:, 0][el]  # [Tp, NL]
    ghigh = gt[:, 1][el]
    iK = torch.arange(K, device=x2.device)
    full = torch.where(iK[None, :, None] == glow[:, None, :], x2[:, 0:1, :], 0.0)
    # The two group members are distinct states, so add-compose is exact.
    return full + torch.where(iK[None, :, None] == ghigh[:, None, :], x2[:, 1:2, :], 0.0)


# ---------------------------------------------------------------------------
# B7: the per-lane transfer products


def prod_sublanes(Tp: int) -> int:
    """G, the sub-lanes B7 and B21 cut a lane of Tp steps into: 1 below
    :data:`PROD_SUBLANES_FROM` steps, else Tp // :data:`PROD_SUBLANE_T`, at
    most :data:`MAX_SUBLANES`; each runs ceil(Tp / G) steps.  A function of
    Tp alone, so the CPU and the card compute the same function.

    Why these numbers: B7 writes no per-step stream, so its sub-lanes cost
    no bytes, and shorter ones only spread the chain wider until the card
    is full.  chip_smoke's sweep at the posterior's 8,192 lanes of 8,192
    steps (H100): sub-lanes of 2 Ki / 1 Ki / 512 / 256 steps ran 0.244 /
    0.177 / 0.153 / 0.156 ms against 1.730 in one chain; 512 (G = 16 on
    the posterior and ``seq`` lanes of 8 Ki steps, 8,192-11,121 lanes x
    16 threads) ties 256 with half the threads.  The CPU tests' lanes
    (4-4.5 Ki steps) stay one chain, the twin's arithmetic bit for bit."""
    if Tp < PROD_SUBLANES_FROM:
        return 1
    return max(1, min(Tp // PROD_SUBLANE_T, MAX_SUBLANES))


def oh_prod_plain(pair2: torch.Tensor, tab_ext: torch.Tensor) -> torch.Tensor:
    """Plain version of B7 -> [4, NL] (rows C00, C01, C10, C11).

    pair2 [Tp, NL] int32, tab_ext [S*S + 1, 4] (identity last; PAD pairs
    clamp onto it).  In one sub-lane (:func:`prod_sublanes`): from the
    identity, each step takes C <- C . T_t, the 2x2 (+, x) product in the
    twin's operand order (each 2-term sum one rounded addition), then
    divides every entry by max(((C00 + C01) + C10) + C11, 1e-30).  With
    G > 1, :func:`_prod_sublanes_plain`."""
    G = prod_sublanes(pair2.shape[0])
    if G > 1:
        return _prod_sublanes_plain(pair2, tab_ext[None], G)[0]
    Tp, NL = pair2.shape
    nreal = tab_ext.shape[0] - 1
    T = tab_ext[torch.clamp_max(pair2, nreal).long()].unbind(0)  # per-step [NL, 4]
    one = torch.ones(NL, dtype=_F32, device=pair2.device)
    zero = torch.zeros(NL, dtype=_F32, device=pair2.device)
    c00, c01, c10, c11 = one, zero, zero, one
    for t in T:
        a00, a01, a10, a11 = t.unbind(1)
        n00 = c00 * a00 + c01 * a10
        n01 = c00 * a01 + c01 * a11
        n10 = c10 * a00 + c11 * a10
        n11 = c10 * a01 + c11 * a11
        tot = torch.clamp_min(((n00 + n01) + n10) + n11, 1e-30)
        c00, c01, c10, c11 = n00 / tot, n01 / tot, n10 / tot, n11 / tot
    return torch.stack([c00, c01, c10, c11])


def _prod_sublanes_plain(pair2: torch.Tensor, tabs: torch.Tensor, G: int) -> torch.Tensor:
    """B7 / B21's sub-lane function for M members -> [M, 4, NL]; tabs [M,
    S*S + 1, 4].

    Each lane's steps split into G sub-lanes [g L, min((g + 1) L, Tp)), L =
    ceil(Tp / G), carried side by side as a [G, NL] axis, in the kernel's
    two phases and its f32 operations in its order:
    1. each sub-lane's product of its steps (:func:`_sub_products_plain`);
    2. from the identity, the sub-lanes' products composed in order, each
       composition :func:`oh_prod_plain`'s step (its product, then every
       entry over its total); an empty sub-lane (g L >= Tp) is skipped."""
    Tp = pair2.shape[0]
    L = -(-Tp // G)
    c00, c01, c10, c11 = _sub_products_plain(pair2, tabs, G)
    one = torch.ones_like(c00[:, 0])
    zero = torch.zeros_like(one)
    C00, C01, C10, C11 = one, zero, zero, one
    for g in range(G):
        if g * L >= Tp:
            break
        p00, p01, p10, p11 = (c[:, g] for c in (c00, c01, c10, c11))
        n00 = C00 * p00 + C01 * p10
        n01 = C00 * p01 + C01 * p11
        n10 = C10 * p00 + C11 * p10
        n11 = C10 * p01 + C11 * p11
        tot = torch.clamp_min(((n00 + n01) + n10) + n11, 1e-30)
        C00, C01, C10, C11 = n00 / tot, n01 / tot, n10 / tot, n11 / tot
    return torch.stack([C00, C01, C10, C11], dim=1)


def _sub_products_plain(pair2: torch.Tensor, tabs: torch.Tensor, G: int):
    """The sub-lanes' 2x2 products of M members over one pair stream (the
    kernels' ``sub_prod``: B7 / B21's phase 1, and the reduced scoring
    chain's) -> (C00, C01, C10, C11), each [M, G, NL]: every step of a
    sub-lane is valid (a PAD pair takes the identity row), so this is
    :func:`_valid_products` over the sub-lanes' real steps."""
    _, _, real, rows = _sublane_grid(pair2.shape[0], G, pair2.device)
    return _valid_products(_pair_steps(tabs, pair2), (tabs.shape[0], G, pair2.shape[1]),
                           real[:, :, None], real, rows)


def oh_prod(pair2: torch.Tensor, tab_ext: torch.Tensor) -> torch.Tensor:
    """Kernel B7 (replaces the JAX package's ``_oh_prod_kernel``) -> [4, NL]
    f32, the lane in :func:`prod_sublanes` sub-lanes.  Arguments as
    :func:`oh_prod_plain`."""
    _check_same_device(pair2, (tab_ext,))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    _check("pair2", pair2, _I32, (Tp, NL))
    _check_table(tab_ext)
    if pair2.device.type == "cpu":
        return oh_prod_plain(pair2, tab_ext)
    out = torch.empty((4, NL), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_prod", pair2, tab_ext, out, Tp=Tp, NL=NL, nreal=tab_ext.shape[0] - 1,
                    G=prod_sublanes(Tp))
    return out


def products_reduced(params: HmmParams, pair2: torch.Tensor) -> torch.Tensor:
    """Per-lane reduced transfer products [NL, 2, 2] of a [lane_T, NL] pair
    stream (kernel B7).  Adjacent lanes' products compose directly: the
    pair stream's forward fill makes lane n's exit group lane n+1's entry
    group, so a 2x2 chain over lanes equals the dense chain exactly."""
    NL = pair2.shape[1]
    red = oh_prod(pair2, prob_tab_ext(params, _groups(params)))
    return red.T.reshape(NL, GROUP, GROUP)


def _scatter_products_prob(red, gt, e_in, e_out, K):
    """[NL, 2, 2] reduced products -> [NL, K, K] dense (zero fill): exact,
    since every consumer multiplies the out-of-group entries by zeros."""
    return _scatter_products(red, gt, e_in, e_out, K, fill=0.0)


def group_select(esym2: torch.Tensor, table: torch.Tensor):
    """(table[esym2, 0], table[esym2, 1]) for a [S, 2] per-symbol table, as
    one compare-and-select pass per symbol (the JAX package's form): at a
    64 Mi span this is several times cheaper than an int64-indexed gather
    into [Tp, NL, 2]."""
    lo = torch.zeros(esym2.shape, dtype=table.dtype, device=esym2.device)
    hi = torch.zeros_like(lo)
    for s in range(table.shape[0]):
        hit = esym2 == s
        lo = torch.where(hit, table[s, 0], lo)
        hi = torch.where(hit, table[s, 1], hi)
    return lo, hi


def conf_from_reduced(alphas2, betas2, esym2, lens2, conf_mask, gt):
    """Per-position island confidence [Tp, NL] from the reduced streams: an
    elementwise epilogue of B4.  Scale-free, so the self-normalized betas
    are exact here.  ``conf_mask`` [K] marks the island states."""
    return _conf_from_mtab(alphas2, betas2, esym2, lens2, conf_mask.to(_F32)[gt])


# ---------------------------------------------------------------------------
# B4: the co-scheduled forward and self-normalized backward chains


def _step_matrices(tab_ext: torch.Tensor, pairs: torch.Tensor, order):
    """Each step's 2x2 matrix as per-step [2 (summed index), 2 (output), NL]
    views; a sum over 2 terms is one rounded addition, x0 + x1, in any
    order.  ``order`` [0, 1, 2, 3] gives [a, c] = T[a, c] (the forward's
    vector-matrix product), [0, 2, 1, 3] gives [c, a] = G[a, c] (the
    backward's matrix-vector product)."""
    Tp, NL = pairs.shape
    nreal = tab_ext.shape[0] - 1
    m = tab_ext[torch.clamp_max(pairs, nreal).long()][..., order]  # [Tp, NL, 4]
    return m.reshape(Tp, NL, 2, 2).permute(0, 2, 3, 1).contiguous().unbind(0)


def oh_fwd_plain(pair2: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor,
                 tab_ext: torch.Tensor) -> torch.Tensor:
    """Plain version of B9 -> alphas2 [Tp, 2, NL]: B4's forward.

    pair2 [Tp, NL] int32, lens2 [1, NL], a0_red [2, NL] the entering
    vector, tab_ext [S*S + 1, 4] (identity last).  alpha_t = (alpha_{t-1} .
    M_t) / sum(alpha_{t-1}) on valid steps (t < len), the entering vector
    at t == 0, carried past the lane's length: raw_c = v0 * T[0, c] + v1 *
    T[1, c], times 1 / (v0 + v1).  In one sub-lane (:func:`sublanes`) the
    twin of ``_xla_fwd_onehot``: both components computed elementwise in
    one [2, NL] tensor, per element the twin's operations in its order.
    With G > 1, :func:`_fwd_sublanes_plain`, B4's forward half."""
    G = sublanes(pair2.shape[0])
    if G > 1:
        return _fwd_sublanes_plain(pair2, lens2, a0_red[None], tab_ext[None], G)[0]
    return fwd_chain_plain(_step_matrices(tab_ext, pair2, [0, 1, 2, 3]), lens2, a0_red)


def fwd_chain_plain(fwd, lens2: torch.Tensor, a0_red: torch.Tensor) -> torch.Tensor:
    """The forward chain of :func:`oh_fwd_plain` over the per-step matrices
    ``fwd`` (a sequence of Tp [2 (summed index a), 2 (output c), NL]
    tensors; step 0's is never read) -> alphas2 [Tp, 2, NL]."""
    Tp = len(fwd)
    valid = (torch.arange(Tp, device=a0_red.device)[:, None] < lens2).unbind(0)
    alphas = [a0_red]
    for t in range(1, Tp):
        v = alphas[-1]
        inv = torch.reciprocal(v.sum(0))
        raw = (v[:, None, :] * fwd[t]).sum(0)
        alphas.append(torch.where(valid[t], raw * inv, v))
    return torch.stack(alphas)


def _bwd_plain(pairn2: torch.Tensor, lens2: torch.Tensor, beta0_red: torch.Tensor,
               tab_ext: torch.Tensor, T: int, cs_next=None) -> torch.Tensor:
    """The backward chain, t = Tp-1 down to 0: beta_t = (M_{t+1} . beta_{t+1})
    times a scale where t <= T-2 and t+1 < len, carried elsewhere.  b_a =
    G[a, 0] * bn0 + G[a, 1] * bn1, the raw contraction first, then the
    scale: 1 / sum(beta_{t+1}) (``cs_next`` None: B4's self-normalized
    betas) or 1 / cs_next[t] (B10's true Rabiner betas)."""
    Tp = pairn2.shape[0]
    steps = torch.arange(Tp, device=pairn2.device)[:, None]
    keep = ((steps <= T - 2) & (steps + 1 < lens2)).unbind(0)
    bwd = _step_matrices(tab_ext, pairn2, [0, 2, 1, 3])
    inv_c = None if cs_next is None else torch.reciprocal(cs_next).unbind(0)
    betas = [beta0_red]
    for tb in range(Tp - 1, -1, -1):
        bn = betas[-1]
        scale = torch.reciprocal(bn.sum(0)) if inv_c is None else inv_c[tb]
        b = (bn[:, None, :] * bwd[tb]).sum(0) * scale
        betas.append(torch.where(keep[tb], b, bn))
    return torch.stack(betas[:0:-1])


def sublanes(Tp: int) -> int:
    """G, the sub-lanes B4 and B24 cut a lane of Tp steps into: Tp //
    :data:`SUBLANE_T`, at least 1 and at most :data:`MAX_SUBLANES`; each
    runs ceil(Tp / G) steps.  A function of Tp alone, so the CPU and the
    card compute the same function."""
    return max(1, min(Tp // SUBLANE_T, MAX_SUBLANES))


def oh_fwdbwd_plain(pair2: torch.Tensor, pairn2: torch.Tensor, lens2: torch.Tensor,
                    a0_red: torch.Tensor, beta0_red: torch.Tensor, tab_ext: torch.Tensor,
                    T: int):
    """Plain version of B4 -> (alphas2 [Tp, 2, NL], betas2 [Tp, 2, NL]).

    pair2 / pairn2 [Tp, NL] int32 (pairn2[t] = pair2[t + 1]), lens2 [1, NL],
    a0_red / beta0_red [2, NL] the entering vectors, tab_ext [S*S + 1, 4]
    (identity last), T the chunk length.  The forward of
    :func:`oh_fwd_plain`, and the self-normalized backward beta_t = (M_{t+1}
    . beta_{t+1}) / sum(beta_{t+1}) for t <= min(T, len) - 2, carried
    elsewhere.  With one sub-lane (:func:`sublanes`) the twin of
    ``_xla_fwdbwd_onehot``, op for op; with G > 1 the lane runs as G
    sub-lanes joined by exact boundary messages
    (:func:`_fwdbwd_sublanes_plain`), equal to the twin in exact
    arithmetic."""
    G = sublanes(pair2.shape[0])
    if G > 1:
        al, be = _fwdbwd_sublanes_plain(pair2, pairn2, lens2, a0_red[None], beta0_red[None],
                                        tab_ext[None], T, G)
        return al[0], be[0]
    return (oh_fwd_plain(pair2, lens2, a0_red, tab_ext),
            _bwd_plain(pairn2, lens2, beta0_red, tab_ext, T))


def _sublane_grid(Tp: int, G: int, dev):
    """The sub-lane layout of a Tp-step lane in G sub-lanes [g L, min((g +
    1) L, Tp)), L = ceil(Tp / G) -> (L, t [G, L] each slot's step, real [G,
    L] t < Tp, rows [G, L] t clamped into the stream)."""
    L = -(-Tp // G)
    t = torch.arange(G, device=dev)[:, None] * L + torch.arange(L, device=dev)
    return L, t, t < Tp, torch.clamp_max(t, Tp - 1)


def _sub_step(tabs: torch.Tensor, pairs: torch.Tensor, rows_k: torch.Tensor):
    """The four entries of every member's step at ``rows_k`` ([G]) of every
    sub-lane -> [M, G, NL] each (tabs [M, nP, 4])."""
    return tabs[:, torch.clamp_max(pairs[rows_k], tabs.shape[1] - 1).long()].unbind(-1)


def _pair_steps(tabs: torch.Tensor, pairs: torch.Tensor):
    """The pair stream's step source (the kernels' ``PairSteps``): rows_k
    [G] -> the four entries of every member's step at ``rows_k`` of every
    sub-lane, [M, G, NL] each (:func:`_sub_step`)."""
    return lambda rows_k: _sub_step(tabs, pairs, rows_k)


def _valid_products(step, shape, ok, real, rows):
    """Every sub-lane's product of its valid steps' matrices (the kernels'
    ``sub_prod``; ``step`` the step source, rows_k [G] -> four [M, G, NL]
    entries, e.g. :func:`_pair_steps`; ``shape`` (M, G, NL); ``ok`` the
    valid steps, [G, L, NL] or [G, L, 1]; ``real`` and ``rows`` from
    :func:`_sublane_grid`) -> (C00, C01, C10, C11), each [M, G, NL]: from
    the identity, C <- C . M entry by entry, times 1 / max(((C00 + C01) +
    C10) + C11, 1e-30) after every 8th step of the sub-lane."""
    L = rows.shape[1]
    one = torch.ones(shape, dtype=_F32, device=rows.device)
    zero = torch.zeros_like(one)
    c00, c01, c10, c11 = one, zero, zero, one
    for k in range(L):
        m0, m1, m2, m3 = step(rows[:, k])
        v = ok[:, k]
        c00, c01, c10, c11 = (
            torch.where(v, c00 * m0 + c01 * m2, c00), torch.where(v, c00 * m1 + c01 * m3, c01),
            torch.where(v, c10 * m0 + c11 * m2, c10), torch.where(v, c10 * m1 + c11 * m3, c11))
        if k % 8 == 7:
            inv = torch.reciprocal(torch.clamp_min(((c00 + c01) + c10) + c11, 1e-30))
            r = real[:, k][:, None]
            c00, c01, c10, c11 = (torch.where(r, c * inv, c) for c in (c00, c01, c10, c11))
    return c00, c01, c10, c11


def _direction_messages(v0, v1, P, has, order, fwd: bool):
    """The degree-0 chains' messages (the kernels' ``sub_message``), sub-lane
    by sub-lane in ``order``: the forward's entering one through (v . P) /
    total, the backward's leaving one through (P . v) / total, a sub-lane
    without a valid step (``has`` [G, NL] false) passing its message on
    unchanged -> (m0, m1), each [M, G, NL], the message of each sub-lane."""
    G = has.shape[0]
    out = [None] * G
    for g in order:
        out[g] = (v0, v1)
        p00, p01, p10, p11 = (c[:, g] for c in P)
        r0 = v0 * p00 + v1 * p10 if fwd else p00 * v0 + p01 * v1
        r1 = v0 * p01 + v1 * p11 if fwd else p10 * v0 + p11 * v1
        inv = torch.reciprocal(torch.clamp_min(r0 + r1, 1e-30))
        v0, v1 = torch.where(has[g], r0 * inv, v0), torch.where(has[g], r1 * inv, v1)
    return (torch.stack([o[0] for o in out], 1), torch.stack([o[1] for o in out], 1))


def _fwd_sublanes_plain(pair2, lens2, a0, tabs, G: int):
    """B4 / B24's forward half, and B9 / B22 in sub-lanes, for M members ->
    alphas [M, Tp, 2, NL]; a0 [M, 2, NL], tabs [M, S*S + 1, 4]:
    :func:`fwd_sublanes_plain` over the pair stream's steps."""
    return fwd_sublanes_plain(_pair_steps(tabs, pair2), pair2.shape[0], lens2, a0, G)


def fwd_sublanes_plain(step, Tp: int, lens2, a0, G: int):
    """The forward chain in G sub-lanes over a step source, the body B4 /
    B24's forward half, B9 / B22 and T2 share -> alphas [M, Tp, 2, NL]; a0
    [M, 2, NL]; ``step`` maps rows_k [G] to the four entries [M, G, NL] of
    each sub-lane's step at rows_k (:func:`_pair_steps`, or T2's streamed
    matrices).

    Each lane's steps split into G sub-lanes [g L, min((g + 1) L, Tp)), L =
    ceil(Tp / G), carried side by side as a [G, NL] axis, in the kernels'
    phases and their f32 operations in their order:
    1. each sub-lane's product of its valid steps' matrices (steps 0 < t <
       len; :func:`_valid_products`);
    2. the entering messages, from a0 through (v . P) / total sub-lane by
       sub-lane in order (:func:`_direction_messages`);
    3. :func:`oh_fwd_plain`'s chain over every sub-lane from its message
       (sub-lane 0's step 0 keeps a0: v = e); past the last valid step
       max(len, 1) - 1 every alpha is that step's."""
    M, _, NL = a0.shape
    dev = a0.device
    L, t, real, rows = _sublane_grid(Tp, G, dev)
    lens = lens2[0]
    tn = t[:, :, None]
    ok = (tn >= 1) & (tn < lens) & real[:, :, None]  # [G, L, NL]
    v0, v1 = _direction_messages(a0[:, 0], a0[:, 1],
                                 _valid_products(step, (M, G, NL), ok, real, rows),
                                 ok.any(1), range(G), True)
    alphas = []
    for k in range(L):
        m0, m1, m2, m3 = step(rows[:, k])
        inv = torch.reciprocal(v0 + v1)
        v = ok[:, k]
        v0, v1 = (torch.where(v, (v0 * m0 + v1 * m2) * inv, v0),
                  torch.where(v, (v0 * m1 + v1 * m3) * inv, v1))
        alphas.append(torch.stack([v0, v1], 1))  # [M, 2, G, NL]
    al = torch.stack(alphas, 3).permute(0, 2, 3, 1, 4).reshape(M, G * L, 2, NL)[:, :Tp]
    return carry_past_last(al, lens)


def carry_past_last(al: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """al [M, Tp, 2, NL] with every row past a lane's last valid step
    max(min(len, Tp), 1) - 1 replaced by that step's (``lens`` [NL]): the
    sub-lane chains' last phase."""
    M, Tp, _, NL = al.shape
    last = torch.clamp_min(torch.clamp_max(lens, Tp), 1) - 1
    src = torch.minimum(torch.arange(Tp, device=al.device)[:, None], last)  # [Tp, NL]
    return torch.gather(al, 1, src[None, :, None, :].expand(M, Tp, 2, NL).long()).contiguous()


def _fwdbwd_sublanes_plain(pair2, pairn2, lens2, a0, beta0, tabs, T: int, G: int):
    """B4 / B24's sub-lane function for M members -> (alphas, betas), each
    [M, Tp, 2, NL]; a0 / beta0 [M, 2, NL], tabs [M, S*S + 1, 4].

    The forward is :func:`_fwd_sublanes_plain`.  The backward, over the same
    sub-lanes and in the kernel's phases: each sub-lane's product of its
    valid steps (t <= T - 2, t + 1 < len) of the next-step pairs, the
    leaving messages from beta0 through (P . v) / total sub-lane by
    sub-lane down, then :func:`_bwd_plain`'s self-normalized chain over
    every sub-lane from its message."""
    Tp, NL = pair2.shape
    M = tabs.shape[0]
    L, t, real, rows = _sublane_grid(Tp, G, pair2.device)
    tn = t[:, :, None]
    ok = (tn < T - 1) & (tn < lens2[0] - 1) & real[:, :, None]
    b0, b1 = _direction_messages(beta0[:, 0], beta0[:, 1],
                                 _valid_products(_pair_steps(tabs, pairn2), (M, G, NL), ok,
                                                 real, rows),
                                 ok.any(1), range(G - 1, -1, -1), False)
    betas = [None] * L
    for k in range(L - 1, -1, -1):
        m0, m1, m2, m3 = _sub_step(tabs, pairn2, rows[:, k])
        inv = torch.reciprocal(b0 + b1)
        v = ok[:, k]
        b0, b1 = (torch.where(v, (m0 * b0 + m1 * b1) * inv, b0),
                  torch.where(v, (m2 * b0 + m3 * b1) * inv, b1))
        betas[k] = torch.stack([b0, b1], 1)
    be = torch.stack(betas, 3).permute(0, 2, 3, 1, 4).reshape(M, G * L, 2, NL)[:, :Tp]
    return _fwd_sublanes_plain(pair2, lens2, a0, tabs, G), be.contiguous()


def _check_same_device(ref: torch.Tensor, tensors) -> None:
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"all operands must share the device {ref.device}")


def _check_table(tab_ext: torch.Tensor) -> None:
    nP = tab_ext.shape[0]
    _check("tab_ext", tab_ext, _F32, (nP, 4))
    if nP > MAX_SYMBOLS * MAX_SYMBOLS + 1:
        raise ValueError(f"pair table of {nP} rows: at most {MAX_SYMBOLS} symbols")


def oh_fwdbwd(pair2: torch.Tensor, pairn2: torch.Tensor, lens2: torch.Tensor,
              a0_red: torch.Tensor, beta0_red: torch.Tensor, tab_ext: torch.Tensor,
              T: int):
    """Kernel B4 (replaces the JAX package's ``_oh_fwdbwd_kernel``) ->
    (alphas2, betas2), each [Tp, 2, NL] f32, the lane in
    :func:`sublanes` sub-lanes.  Arguments as :func:`oh_fwdbwd_plain`."""
    _check_same_device(pair2, (pairn2, lens2, a0_red, beta0_red, tab_ext))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("pairn2", pairn2, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check("a0_red", a0_red, _F32, (GROUP, NL))
    _check("beta0_red", beta0_red, _F32, (GROUP, NL))
    _check_table(tab_ext)
    G = sublanes(Tp)
    if pair2.device.type == "cpu":
        return oh_fwdbwd_plain(pair2, pairn2, lens2, a0_red, beta0_red, tab_ext, T)
    alphas = torch.empty((Tp, GROUP, NL), dtype=_F32, device=pair2.device)
    betas = torch.empty((Tp, GROUP, NL), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_fwdbwd", pair2, pairn2, lens2, a0_red, beta0_red, tab_ext,
                    alphas, betas, Tp=Tp, NL=NL, nreal=tab_ext.shape[0] - 1, T=T, G=G)
    return alphas, betas


# ---------------------------------------------------------------------------
# B9-B11: the split arm's chains (forward alone; cs-scaled backward, or the
# backward emitting the island confidence)


def _check_chain_operands(pairs: torch.Tensor, lens2: torch.Tensor, tab_ext: torch.Tensor,
                          others) -> tuple:
    """Device, shape and type checks shared by the chain wrappers ->
    (Tp, NL)."""
    _check_same_device(pairs, (lens2, tab_ext, *others))
    if pairs.dim() != 2 or 0 in pairs.shape:
        raise ValueError(f"pair stream must be a non-empty [Tp, NL], got {tuple(pairs.shape)}")
    Tp, NL = pairs.shape
    _check("pairs", pairs, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check_table(tab_ext)
    return Tp, NL


def oh_fwd(pair2: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor,
           tab_ext: torch.Tensor) -> torch.Tensor:
    """Kernel B9 (replaces the JAX package's ``_oh_fwd_kernel``) -> alphas2
    [Tp, 2, NL] f32, the lane in :func:`sublanes` sub-lanes (B4's), equal
    to B4's alphas.  Arguments as :func:`oh_fwd_plain`."""
    Tp, NL = _check_chain_operands(pair2, lens2, tab_ext, (a0_red,))
    _check("a0_red", a0_red, _F32, (GROUP, NL))
    if pair2.device.type == "cpu":
        return oh_fwd_plain(pair2, lens2, a0_red, tab_ext)
    return _launch_fwd(pair2, lens2, a0_red, tab_ext, stacked=False)


def _launch_fwd(pair2, lens2, a0, tabs, stacked: bool) -> torch.Tensor:
    """B9 (tabs [nP, 4]) or B22 (``stacked``, tabs [M, nP, 4]) on the card
    -> alphas [Tp, 2, NL] or [M, Tp, 2, NL]; in G > 1 the sub-lanes'
    products in a [M, G, 4, NL] scratch."""
    Tp, NL = pair2.shape
    M = tabs.shape[0] if stacked else 1
    G = sublanes(Tp)
    dev = pair2.device
    alphas = torch.empty(((M,) if stacked else ()) + (Tp, GROUP, NL), dtype=_F32, device=dev)
    pbuf = torch.empty((M, G, 4, NL) if G > 1 else (1,), dtype=_F32, device=dev)
    ints = dict(Tp=Tp, NL=NL, nreal=tabs.shape[-2] - 1, G=G)
    _kernels.launch("oh_fwd_stacked" if stacked else "oh_fwd", pair2, lens2, a0, tabs, alphas,
                    pbuf, **(ints | ({"M": M} if stacked else {})))
    return alphas


def cs_next_of(alphas2: torch.Tensor) -> torch.Tensor:
    """[..., Tp, NL] c_{t+1} = a0 + a1 of the alphas at t + 1, 1 at the last
    row: the split backward's scale (``alphas2`` [..., Tp, 2, NL]).  Built
    on the alphas' device: no host value enters the stream."""
    cs = alphas2[..., 1:, 0, :] + alphas2[..., 1:, 1, :]
    one = torch.ones(cs.shape[:-2] + (1, cs.shape[-1]), dtype=_F32, device=alphas2.device)
    return torch.cat([cs, one], dim=-2).contiguous()


def split_bwd_sublanes(Tp: int) -> int:
    """G, the sub-lanes B10 and B23 cut a lane of Tp steps into: B18's rule
    at K = 2 (``fb_pallas.bwd_sublanes``, its ``BWD_SUBLANE_T`` and
    ``BWD_SUBLANES_FROM``), the same backward chain with magnitude messages
    on the reduced 2x2 table; each sub-lane runs ceil(Tp / G) steps.  A
    function of Tp alone, so the CPU and the card compute the same
    function.  Lanes below 8 Ki steps (the CPU tests' 4-4.5 Ki chunks) stay
    one chain, the twin's arithmetic op for op.  Why 1 Ki steps for B10 too:
    chip_smoke's sweep (H100) could not tell 256 to 2 Ki apart on the
    training batch, and 512 from 1 Ki on the posterior lanes."""
    from cpgisland_tpu_torch.ops import fb_pallas  # fb_pallas imports this module

    return fb_pallas.bwd_sublanes(Tp, GROUP)


def scale_exp(x: torch.Tensor) -> torch.Tensor:
    """x's binary exponent as int32 (frexp's for a normal x; -126 for 0 and
    subnormals), clamped to [-126, 126]: the kernels' scale_exp, read off
    the float's bits."""
    return torch.clamp(((x.view(torch.int32) >> 23) & 0xFF) - 126, -126, 126)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for int32 -126 <= e <= 126 (a normal float, built
    from its bits as the kernels' pow2f)."""
    return ((e + 127) << 23).view(_F32)


def oh_bwd_plain(pairn2: torch.Tensor, lens2: torch.Tensor, cs_next: torch.Tensor,
                 beta0_red: torch.Tensor, tab_ext: torch.Tensor, T: int) -> torch.Tensor:
    """Plain version of B10 -> betas2 [Tp, 2, NL], the true Rabiner
    (cs-scaled) betas.  pairn2 [Tp, NL] the time-shifted pairs (last row
    the identity's PAD), cs_next [Tp, NL] (:func:`cs_next_of`), beta0_red
    [2, NL] the exit vector.  beta_t = (G[a, 0] * bn0 + G[a, 1] * bn1) * (1
    / cs_next[t]) where t <= T-2 and t+1 < len, else carried.  In one
    sub-lane (:func:`split_bwd_sublanes`) the twin of ``_xla_bwd_onehot``,
    op for op; with G > 1, :func:`_split_bwd_sublanes_plain`."""
    G = split_bwd_sublanes(pairn2.shape[0])
    if G > 1:
        return _split_bwd_sublanes_plain(pairn2, lens2, cs_next[None], beta0_red[None],
                                         tab_ext[None], T, G)[0]
    return _bwd_plain(pairn2, lens2, beta0_red, tab_ext, T, cs_next=cs_next)


def _split_bwd_sublanes_plain(pairn2, lens2, cs_next, beta0, tabs, T: int, G: int):
    """B10 / B23's sub-lane function for M members -> betas [M, Tp, 2, NL];
    cs_next [M, Tp, NL], beta0 [M, 2, NL], tabs [M, S*S + 1, 4].

    The chain is DEGREE 1 in beta (B12 reads the Rabiner scale), so the
    messages carry the betas' magnitude, as B18's do.  Each lane's steps
    split into G sub-lanes [g L, min((g + 1) L, Tp)), L = ceil(Tp / G),
    carried side by side as a [G, NL] axis, in the kernel's phases and its
    f32 operations in its order:
    1. each sub-lane's transfer matrix Q (beta at its start = Q . beta at
       its end) over its valid steps t < min(T - 1, len - 1), from the
       identity, the chain's step applied to every column (contract, then
       times 1 / c_{t+1}), t walking down; after every 8th step counted
       from the sub-lane's padded end, Q times 2^-e with e the binary
       exponent of its total ((Q00 + Q01) + Q10) + Q11, e summed into an
       int E;
    2. the messages, from beta0 at the lane's end, sub-lane by sub-lane
       down: v <- Q . v, then v times 2^-e (e of v0 + v1) and the exponents
       summed; a sub-lane without a valid step passes v on unchanged; a
       sub-lane's chain starts from (v 2^E1) 2^E2, E = E1 + E2, E1 = E / 2
       truncated;
    3. :func:`oh_bwd_plain`'s chain over every sub-lane from its message.
    Products by powers of two are exact away from subnormals, so the
    messages are, in exact arithmetic, the sequential chain's betas."""
    Tp, NL = pairn2.shape
    M = tabs.shape[0]
    dev = pairn2.device
    L, t, real, rows = _sublane_grid(Tp, G, dev)
    hi = torch.clamp_max(lens2[0] - 1, T - 1)
    ok = (t[:, :, None] < hi) & real[:, :, None]  # [G, L, NL]: the valid steps
    invc = torch.reciprocal(cs_next)

    def step(k):  # step k of every sub-lane: its matrix entries and 1 / c, [M, G, NL] each
        return (*_sub_step(tabs, pairn2, rows[:, k]), invc[:, rows[:, k]])

    # Phase 1: Q (q{row}{column}) and E, [M, G, NL] each.
    one = torch.ones((M, G, NL), dtype=_F32, device=dev)
    zero = torch.zeros_like(one)
    q00, q01, q10, q11 = one, zero, zero, one
    E = torch.zeros((M, G, NL), dtype=torch.int32, device=dev)
    for s in range(L):
        k = L - 1 - s
        m0, m1, m2, m3, ic = step(k)
        v = ok[:, k]
        q00, q01, q10, q11 = (
            torch.where(v, (m0 * q00 + m1 * q10) * ic, q00),
            torch.where(v, (m0 * q01 + m1 * q11) * ic, q01),
            torch.where(v, (m2 * q00 + m3 * q10) * ic, q10),
            torch.where(v, (m2 * q01 + m3 * q11) * ic, q11))
        if s % 8 == 7:
            r = real[:, k][:, None]
            e = scale_exp(((q00 + q01) + q10) + q11)
            sc = pow2(-e)
            q00, q01, q10, q11 = (torch.where(r, q * sc, q) for q in (q00, q01, q10, q11))
            E = torch.where(r, E + e, E)

    # Phase 2: each sub-lane's entering beta (the beta after its last step).
    has = ok.any(1)
    v0, v1 = beta0[:, 0], beta0[:, 1]
    Ev = torch.zeros((M, NL), dtype=torch.int32, device=dev)
    starts = [None] * G
    for g in range(G - 1, -1, -1):
        e1 = torch.div(Ev, 2, rounding_mode="trunc")
        s1, s2 = pow2(torch.clamp(e1, -126, 126)), pow2(torch.clamp(Ev - e1, -126, 126))
        starts[g] = ((v0 * s1) * s2, (v1 * s1) * s2)
        r0 = q00[:, g] * v0 + q01[:, g] * v1
        r1 = q10[:, g] * v0 + q11[:, g] * v1
        e = scale_exp(r0 + r1)
        sc = pow2(-e)
        v0, v1 = torch.where(has[g], r0 * sc, v0), torch.where(has[g], r1 * sc, v1)
        Ev = torch.where(has[g], Ev + (E[:, g] + e), Ev)

    # Phase 3: the chains, t = (g + 1) L - 1 down to g L.
    b0 = torch.stack([s[0] for s in starts], 1)  # [M, G, NL]
    b1 = torch.stack([s[1] for s in starts], 1)
    out = [None] * L
    for k in range(L - 1, -1, -1):
        m0, m1, m2, m3, ic = step(k)
        v = ok[:, k]
        b0, b1 = (torch.where(v, (m0 * b0 + m1 * b1) * ic, b0),
                  torch.where(v, (m2 * b0 + m3 * b1) * ic, b1))
        out[k] = torch.stack([b0, b1], 1)  # [M, 2, G, NL]
    be = torch.stack(out, 3).permute(0, 2, 3, 1, 4).reshape(M, G * L, 2, NL)[:, :Tp]
    return be.contiguous()


def oh_bwd(pairn2: torch.Tensor, lens2: torch.Tensor, cs_next: torch.Tensor,
           beta0_red: torch.Tensor, tab_ext: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel B10 (replaces ``_oh_bwd_kernel``) -> betas2 [Tp, 2, NL] f32,
    the lane in :func:`split_bwd_sublanes` sub-lanes.  Arguments as
    :func:`oh_bwd_plain`."""
    Tp, NL = _check_chain_operands(pairn2, lens2, tab_ext, (cs_next, beta0_red))
    _check("cs_next", cs_next, _F32, (Tp, NL))
    _check("beta0_red", beta0_red, _F32, (GROUP, NL))
    if pairn2.device.type == "cpu":
        return oh_bwd_plain(pairn2, lens2, cs_next, beta0_red, tab_ext, T)
    return _launch_bwd(pairn2, lens2, cs_next, beta0_red, tab_ext, T, stacked=False)


def _launch_bwd(pairn2, lens2, cs_next, beta0, tabs, T: int, stacked: bool) -> torch.Tensor:
    """B10 (tabs [nP, 4]) or B23 (``stacked``, tabs [M, nP, 4]) on the card
    -> betas [Tp, 2, NL] or [M, Tp, 2, NL]; in G > 1 the sub-lanes'
    transfer matrices and exponents in a [M, G, 5, NL] scratch."""
    Tp, NL = pairn2.shape
    M = tabs.shape[0] if stacked else 1
    G = split_bwd_sublanes(Tp)
    dev = pairn2.device
    betas = torch.empty(((M,) if stacked else ()) + (Tp, GROUP, NL), dtype=_F32, device=dev)
    qbuf = torch.empty((M, G, 5, NL) if G > 1 else (1,), dtype=_F32, device=dev)
    ints = dict(Tp=Tp, NL=NL, nreal=tabs.shape[-2] - 1, T=T, G=G)
    _kernels.launch("oh_bwd_stacked" if stacked else "oh_bwd", pairn2, lens2, cs_next, beta0,
                    tabs, betas, qbuf, **(ints | ({"M": M} if stacked else {})))
    return betas


def _conf_from_mtab(alphas2, betas2, esym2, lens2, mtab) -> torch.Tensor:
    """conf [Tp, NL] = (m0 * g0 + m1 * g1) / max(g0 + g1, 1e-30) on valid
    steps, 0 elsewhere; g = alpha * beta, (m0, m1) = mtab[esym] ([S, 2],
    the island mask of each symbol's two group states)."""
    m0, m1 = group_select(esym2, mtab)
    graw0 = alphas2[:, 0] * betas2[:, 0]
    graw1 = alphas2[:, 1] * betas2[:, 1]
    tot = torch.clamp_min(graw0 + graw1, 1e-30)
    vmask = torch.arange(alphas2.shape[0], device=alphas2.device)[:, None] < lens2
    return torch.where(vmask, (m0 * graw0 + m1 * graw1) / tot, 0.0)


def oh_bwd_conf_plain(pairn2, pair2, lens2, cs_next, beta0_red, alphas2, mtab, tab_ext,
                      T: int) -> torch.Tensor:
    """Plain version of B11 -> conf [Tp, NL]: B10's betas (:func:`oh_bwd_plain`,
    in B10's sub-lanes) reduced to the island confidence — in one sub-lane
    the twin is the off-TPU branch of the JAX runner, ``(m0*g0 + m1*g1) /
    tot``, op for op.  So a confidence-only run equals the confidence from
    B10's or B23's betas (:func:`conf_from_reduced`) bit for bit.
    pair2 [Tp, NL] the pairs (each position's symbol), alphas2 [Tp, 2, NL]
    B9's alphas, mtab [S, 2] f32 the island mask of each symbol's group
    states; the rest as :func:`oh_bwd_plain`."""
    betas2 = oh_bwd_plain(pairn2, lens2, cs_next, beta0_red, tab_ext, T)
    return _conf_from_mtab(alphas2, betas2, decode_esym(pair2, mtab.shape[0]), lens2, mtab)


def oh_bwd_conf(pairn2, pair2, lens2, cs_next, beta0_red, alphas2, mtab, tab_ext,
                T: int) -> torch.Tensor:
    """Kernel B11 (replaces ``_oh_bwd_conf_kernel``) -> conf [Tp, NL] f32,
    B10's chain in B10's :func:`split_bwd_sublanes` (its sub-lanes'
    transfer matrices in a [G, 5, NL] scratch, shared with B10's); the
    betas never reach device memory.  Arguments as
    :func:`oh_bwd_conf_plain`."""
    Tp, NL = _check_chain_operands(pairn2, lens2, tab_ext,
                                   (pair2, cs_next, beta0_red, alphas2, mtab))
    S = mtab.shape[0]
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("cs_next", cs_next, _F32, (Tp, NL))
    _check("beta0_red", beta0_red, _F32, (GROUP, NL))
    _check("alphas2", alphas2, _F32, (Tp, GROUP, NL))
    _check("mtab", mtab, _F32, (S, GROUP))
    if tab_ext.shape[0] != S * S + 1:
        raise ValueError(f"pair table has {tab_ext.shape[0]} rows, expected {S * S + 1}")
    if pair2.device.type == "cpu":
        return oh_bwd_conf_plain(pairn2, pair2, lens2, cs_next, beta0_red, alphas2, mtab,
                                 tab_ext, T)
    G = split_bwd_sublanes(Tp)
    conf = torch.empty((Tp, NL), dtype=_F32, device=pair2.device)
    qbuf = torch.empty((1, G, 5, NL) if G > 1 else (1,), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_bwd_conf", pairn2, pair2, lens2, cs_next, beta0_red, alphas2, mtab,
                    tab_ext, conf, qbuf, Tp=Tp, NL=NL, S=S, T=T, G=G)
    return conf


# ---------------------------------------------------------------------------
# B8: the entry-free matrix-carried chains (the one-pass arm)


def oh_fwdbwd_mat_plain(pair2: torch.Tensor, pairn2: torch.Tensor, lens2: torch.Tensor,
                        tab_ext: torch.Tensor, T: int):
    """Plain version of B8 -> (va [Tp, 4, NL], wb [Tp, 4, NL]), rows 00, 01,
    10, 11 of each step's 2x2 matrix.

    The twin of ``_xla_fwdbwd_mat_onehot``: both chains carried as 2x2
    matrices from the identity, so no entry vector is needed.  Forward:
    V <- V . M_t times 1 / (((V00 + V01) + V10) + V11) on valid steps
    (t < len), carried past the lane's length; position 0 stores the
    identity (M_0 belongs to the entry direction).  Backward, t = Tp-1 down
    to 0: W <- M_{t+1} . W times 1 / the previous W's total where t <= T-2
    and t+1 < len, else carried.  Each entry is a 2-term sum (one rounded
    addition) of rounded products, in the twin's operand order."""
    Tp, NL = pair2.shape
    nreal = tab_ext.shape[0] - 1
    steps = torch.arange(Tp, device=pair2.device)[:, None]
    valid = (steps < lens2).unbind(0)
    keep = ((steps <= T - 2) & (steps + 1 < lens2)).unbind(0)

    def matrices(pairs):
        # Each step's matrix as [2 (row), 2 (column), NL].
        m = tab_ext[torch.clamp_max(pairs, nreal).long()]  # [Tp, NL, 4]
        return m.permute(0, 2, 1).reshape(Tp, 2, 2, NL).contiguous().unbind(0)

    def total(x):
        return ((x[0, 0] + x[0, 1]) + x[1, 0]) + x[1, 1]

    eye = torch.eye(2, dtype=_F32, device=pair2.device)[:, :, None].expand(2, 2, NL)
    # r[i, j] = V[i, 0] * M[0, j] + V[i, 1] * M[1, j], then times 1 / total(V).
    fwd = matrices(pair2)
    va = [eye]
    for t in range(1, Tp):
        v = va[-1]
        inv = torch.reciprocal(total(v))
        m = fwd[t]
        raw = v[:, 0:1, :] * m[0:1] + v[:, 1:2, :] * m[1:2]
        va.append(torch.where(valid[t], raw * inv, v))
    # b[i, j] = (G[i, 0] * W[0, j] + G[i, 1] * W[1, j]) * (1 / total(W)).
    bwd = matrices(pairn2)
    wb = [eye]
    for tb in range(Tp - 1, -1, -1):
        w = wb[-1]
        binv = torch.reciprocal(total(w))
        g = bwd[tb]
        b = (g[:, 0:1, :] * w[0:1] + g[:, 1:2, :] * w[1:2]) * binv
        wb.append(torch.where(keep[tb], b, w))
    return (torch.stack(va).reshape(Tp, 4, NL),
            torch.stack(wb[:0:-1]).reshape(Tp, 4, NL))


def oh_fwdbwd_mat(pair2: torch.Tensor, pairn2: torch.Tensor, lens2: torch.Tensor,
                  tab_ext: torch.Tensor, T: int):
    """Kernel B8 (replaces the JAX package's ``_oh_fwdbwd_mat_kernel``) ->
    (va, wb), each [Tp, 4, NL] f32.  Arguments as
    :func:`oh_fwdbwd_mat_plain`."""
    _check_same_device(pair2, (pairn2, lens2, tab_ext))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("pairn2", pairn2, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check_table(tab_ext)
    if pair2.device.type == "cpu":
        return oh_fwdbwd_mat_plain(pair2, pairn2, lens2, tab_ext, T)
    va = torch.empty((Tp, 4, NL), dtype=_F32, device=pair2.device)
    wb = torch.empty((Tp, 4, NL), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_fwdbwd_mat", pair2, pairn2, lens2, tab_ext, va, wb,
                    Tp=Tp, NL=NL, nreal=tab_ext.shape[0] - 1, T=T)
    return va, wb


# ---------------------------------------------------------------------------
# B5: z-normalized counts from the reduced streams


def _gamma_emit_ll(alphas2, betas2, esym2, vmask, S: int):
    """The gamma rows and the loglik shared by B5's and B12's plain
    versions: (emit_red [2S, NL] — per symbol s, the time sums of
    normalize(alpha * beta) over its positions —, ll [1, NL] — the sum of
    log max(c_t, 1e-30) over valid steps —, inv_cs [Tp, NL] = 1 / max(c_t,
    1e-30)), c_t = a0 + a1."""
    a0, a1 = alphas2[:, 0], alphas2[:, 1]
    cs = a0 + a1
    inv_cs = torch.reciprocal(torch.clamp_min(cs, 1e-30))
    g0, g1 = a0 * betas2[:, 0], a1 * betas2[:, 1]
    inv_g = torch.reciprocal(torch.clamp_min(g0 + g1, 1e-30))
    gm0 = torch.where(vmask, g0 * inv_g, 0.0)
    gm1 = torch.where(vmask, g1 * inv_g, 0.0)
    emit_rows = []
    for s in range(S):
        m = esym2 == s
        emit_rows.append(torch.sum(torch.where(m, gm0, 0.0), dim=0))
        emit_rows.append(torch.sum(torch.where(m, gm1, 0.0), dim=0))
    ll = torch.sum(torch.where(vmask, torch.log(torch.clamp_min(cs, 1e-30)), 0.0),
                   dim=0)[None, :]
    return torch.stack(emit_rows, dim=0), ll, inv_cs


def _check_f32_matmul(x: torch.Tensor, what: str) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} needs full f32 matmuls (allow_tf32 is set)")


def oh_seq_stats_plain(alphas2, betas2, pair2, lens2, tab_ext, B_red, gt,
                       enters_full, enters_red, pair0m):
    """Plain version of B5 -> (macc [K*K, NL], emit_red [2S, NL], ll [1, NL]).

    alphas2 / betas2 [Tp, 2, NL] (betas with any per-position scale),
    pair2 [Tp, NL], lens2 [1, NL], tab_ext [S*S + 1, 4], B_red [S, 2] (the
    emission probability of each group member), gt [S, 2] state ids,
    enters_full [K, NL] / enters_red [2, NL] the previous alpha at
    within-lane t == 0, pair0m [1, NL] the mask of that t == 0 pair.  The
    twin of ``_xla_znorm_stats``: time sums as tensor reductions and the
    xi counts as one batched product over t."""
    Tp, _, NL = alphas2.shape
    S = gt.shape[0]
    K = enters_full.shape[0]
    _check_f32_matmul(alphas2, "oh_seq_stats_plain")
    T4 = tab_ext[torch.clamp_max(pair2, S * S).long()]  # [Tp, NL, 4]
    esym2 = decode_esym(pair2, S)
    el = esym2.long()
    a0, a1 = alphas2[:, 0], alphas2[:, 1]
    be0, be1 = betas2[:, 0], betas2[:, 1]
    vmask = torch.arange(Tp, device=pair2.device)[:, None] < lens2
    emit_red, ll, inv_cs = _gamma_emit_ll(alphas2, betas2, esym2, vmask, S)
    # The previous position's normalized alpha, the entering message at t == 0.
    ah2 = torch.stack([a0 * inv_cs, a1 * inv_cs], dim=1)  # [Tp, 2, NL]
    ah_full = scatter_streams(ah2, gt, esym2, K)
    ap2 = torch.cat([enters_red[None], ah2[:-1]], dim=0)
    apf = torch.cat([enters_full[None], ah_full[:-1]], dim=0)
    pairm = vmask.to(_F32)
    pairm[0] = pairm[0] * pair0m[0]
    z = ap2[:, 0] * (T4[..., 0] * be0 + T4[..., 1] * be1) + \
        ap2[:, 1] * (T4[..., 2] * be0 + T4[..., 3] * be1)
    inv_z = pairm * torch.reciprocal(torch.clamp_min(z, 1e-30))
    w_full = scatter_streams(
        torch.stack([B_red[el, 0] * be0, B_red[el, 1] * be1], dim=1), gt, esym2, K
    )
    wz = w_full * inv_z[:, None, :]
    macc = torch.einsum("tin,tjn->ijn", apf, wz).reshape(K * K, NL)
    return macc, emit_red, ll


def stats_segment_t(Tp: int, NL: int) -> int:
    """B5 / B25 / B12's segment length for a [Tp, NL] layout: the kernel gives
    each (lane, segment) a thread, so the segments set how many threads the
    card gets and how many partial sums the reduce reads.  A function of
    the shape alone (not of the layout's ``Tt``, the TPU's tile), so the
    CPU and the card compute the same function:
    min(:data:`STATS_SEGMENT_T`, Tp).

    Why 512: the sweep of ``python -m
    cpgisland_tpu_torch.tools.kernel_variants`` (the kernel alone, H100)
    over segments of 128 / 256 / 512 / 1 Ki steps.  On the main
    path's shapes, the genome's 1,390 training chunks of 65,536 steps and
    its 11,121 ``seq`` lanes of 8,192, 512 was fastest (0.907 and 0.908
    ms; 256: 0.925 and 0.926; 1 Ki: 1.070 and 1.082, a grid of one wave
    and a sliver); on 1,024 x 65,536 and 8,192 x 8,192 it ran within 2% of
    the fastest, 1 Ki (0.660 against 0.651, 0.649 against 0.642).  That
    512 is also the layout's default t-tile at these shapes is a
    coincidence the rule does not rely on: a layout prepared with another
    tile gets the same segments."""
    return max(1, min(STATS_SEGMENT_T, Tp))


def stats_segments_per_block(S: int) -> int:
    """Segments a block of B5 / B25 / B12 sums before the reduce: 4 (a block of
    32 lanes x 4 segments, 128 threads) where the block's R = 4 S^2 + 2S + 1
    accumulator columns fit in 200 KB of shared memory, else 1 (S = 16)."""
    return 4 if (4 * S * S + 2 * S + 1) * 128 * 4 <= 200 * 1024 else 1


def _stats_part_rows(Tp: int, NL: int, S: int) -> int:
    """Partial row sets a lane of B5 / B25 / B12 leaves for the reduce."""
    nseg = -(-Tp // stats_segment_t(Tp, NL))
    return -(-nseg // stats_segments_per_block(S))


def oh_seq_stats(alphas2, betas2, pair2, lens2, tab_ext, B_red, gt, enters_full,
                 enters_red, pair0m):
    """Kernel B5 (replaces ``_oh_seq_stats_kernel``) -> (macc, emit_red, ll).
    Arguments as :func:`oh_seq_stats_plain`; the kernel reduces each lane
    in segments of :func:`stats_segment_t` steps, sums each block's
    :func:`stats_segments_per_block` segments, then the blocks' sums in
    order (no atomics: the result does not change from run to run)."""
    _check_same_device(pair2, (alphas2, betas2, lens2, tab_ext, B_red, gt,
                               enters_full, enters_red, pair0m))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    S = gt.shape[0]
    K = enters_full.shape[0]
    if K != GROUP * S:
        raise ValueError(f"{K} states for {S} symbols: the reduced stats need K == 2S")
    _check("alphas2", alphas2, _F32, (Tp, GROUP, NL))
    _check("betas2", betas2, _F32, (Tp, GROUP, NL))
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check_table(tab_ext)
    if tab_ext.shape[0] != S * S + 1:
        raise ValueError(f"pair table has {tab_ext.shape[0]} rows, expected {S * S + 1}")
    _check("B_red", B_red, _F32, (S, GROUP))
    _check("gt", gt, _I32, (S, GROUP))
    _check("enters_full", enters_full, _F32, (K, NL))
    _check("enters_red", enters_red, _F32, (GROUP, NL))
    _check("pair0m", pair0m, _F32, (1, NL))
    if pair2.device.type == "cpu":
        return oh_seq_stats_plain(alphas2, betas2, pair2, lens2, tab_ext, B_red, gt,
                                  enters_full, enters_red, pair0m)
    dev = pair2.device
    rows = 4 * S * S + 2 * S + 1  # per-lane accumulators: pair bins, emit, ll
    part = torch.empty((_stats_part_rows(Tp, NL, S), rows, NL), dtype=_F32, device=dev)
    macc = torch.empty((K * K, NL), dtype=_F32, device=dev)
    emit_red = torch.empty((2 * S, NL), dtype=_F32, device=dev)
    ll = torch.empty((1, NL), dtype=_F32, device=dev)
    _kernels.launch("oh_seq_stats", alphas2, betas2, pair2, lens2, tab_ext, B_red, gt,
                    enters_full, enters_red, pair0m, part, macc, emit_red, ll,
                    Tp=Tp, NL=NL, S=S, K=K, Tt=stats_segment_t(Tp, NL),
                    SPB=stats_segments_per_block(S))
    return macc, emit_red, ll


# ---------------------------------------------------------------------------
# B12: the chunked counts over the split arm's cs-scaled streams


def oh_stats_plain(alphas2, betas2, pair2, lens2, B_red, gt):
    """Plain version of B12 -> (macc [K*K, NL], emit_red [2S, NL], ll [1,
    NL]), K = 2S: the twin of the interpret branch of the JAX package's
    ``run_stats_onehot``.

    alphas2 / betas2 [Tp, 2, NL] the split arm's streams (betas
    cs-scaled: macc is DEGREE 1 in them), pair2 [Tp, NL], lens2 [1, NL],
    B_red [S, 2], gt [S, 2] state ids.  Gamma rows and loglik as B5's;
    the counts xi[t] = a_hat_{t-1} (x) w_t with a_hat = alpha / c and w =
    B_red[s_t] * beta_t / c_t, scattered to the dense K rows, summed over
    1 <= t < len (each lane's t == 0 pair excluded: every chunk lane is
    its own record) as one batched product over t."""
    Tp, _, NL = alphas2.shape
    S = gt.shape[0]
    K = GROUP * S
    _check_f32_matmul(alphas2, "oh_stats_plain")
    esym2 = decode_esym(pair2, S)
    el = esym2.long()
    a0, a1 = alphas2[:, 0], alphas2[:, 1]
    be0, be1 = betas2[:, 0], betas2[:, 1]
    steps = torch.arange(Tp, device=pair2.device)[:, None]
    vmask = steps < lens2
    emit_red, ll, inv_cs = _gamma_emit_ll(alphas2, betas2, esym2, vmask, S)
    w_full = scatter_streams(
        torch.stack([B_red[el, 0] * be0 * inv_cs, B_red[el, 1] * be1 * inv_cs], dim=1),
        gt, esym2, K)
    a_hat = scatter_streams(torch.stack([a0 * inv_cs, a1 * inv_cs], dim=1), gt, esym2, K)
    pairm = (vmask & (steps >= 1))[:, None, :]
    aprev = torch.cat([torch.zeros_like(a_hat[:1]), a_hat[:-1]], dim=0)
    aprev = torch.where(pairm, aprev, 0.0)
    wq = torch.where(pairm, w_full, 0.0)
    macc = torch.einsum("tin,tjn->ijn", aprev, wq).reshape(K * K, NL)
    return macc, emit_red, ll


def oh_stats(alphas2, betas2, pair2, lens2, B_red, gt):
    """Kernel B12 (replaces ``_oh_stats_kernel``) -> (macc, emit_red, ll).
    Arguments as :func:`oh_stats_plain` (gt int32).  B5's kernels with the
    cs-scaled normalizer: each lane in segments of :func:`stats_segment_t`
    steps, each block's :func:`stats_segments_per_block` segments summed,
    then the blocks' sums in order (no atomics: the result does not change
    from run to run)."""
    _check_same_device(pair2, (alphas2, betas2, lens2, B_red, gt))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    S = gt.shape[0]
    K = GROUP * S
    if S > MAX_SYMBOLS:
        raise ValueError(f"{S} symbols: the stats kernel takes at most {MAX_SYMBOLS}")
    _check("alphas2", alphas2, _F32, (Tp, GROUP, NL))
    _check("betas2", betas2, _F32, (Tp, GROUP, NL))
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check("B_red", B_red, _F32, (S, GROUP))
    _check("gt", gt, _I32, (S, GROUP))
    if pair2.device.type == "cpu":
        return oh_stats_plain(alphas2, betas2, pair2, lens2, B_red, gt)
    dev = pair2.device
    rows = 4 * S * S + 2 * S + 1  # per-lane accumulators: pair bins, emit, ll
    part = torch.empty((_stats_part_rows(Tp, NL, S), rows, NL), dtype=_F32, device=dev)
    macc = torch.empty((K * K, NL), dtype=_F32, device=dev)
    emit_red = torch.empty((2 * S, NL), dtype=_F32, device=dev)
    ll = torch.empty((1, NL), dtype=_F32, device=dev)
    _kernels.launch("oh_stats", alphas2, betas2, pair2, lens2, B_red, gt, part, macc, emit_red,
                    ll, Tp=Tp, NL=NL, S=S, K=K, Tt=stats_segment_t(Tp, NL),
                    SPB=stats_segments_per_block(S))
    return macc, emit_red, ll


# ---------------------------------------------------------------------------
# Runners (the JAX module's entry points)


def _reduced_operands(params: HmmParams, gt, esym2, a0_raw, beta0):
    """(a0_red, beta0_red) [2, NL]: the full-K entering vectors projected
    onto each lane's entry / exit group."""
    a0_red = torch.gather(a0_raw.T, 1, gt[esym2[0].long()]).T.contiguous()
    beta0_red = torch.gather(beta0.T, 1, gt[esym2[-1].long()]).T.contiguous()
    return a0_red.to(_F32), beta0_red.to(_F32)


def _streams(S: int, pair_esym, sel_t, prev_dev):
    """(pair2, esym2, pairn2): the prepared stream, or one built from
    ``sel_t`` and ``prev_dev``."""
    from cpgisland_tpu_torch.ops.prepared import _pair_next

    if pair_esym is None:
        pair2, _, _ = pair_stream(S, sel_t, prev_dev)
        return pair2, decode_esym(pair2, S), _pair_next(pair2, S)
    pair2, esym2, pairn2 = pair_esym
    return pair2, decode_esym(pair2, S) if esym2 is None else esym2, pairn2


def run_fb_kernels_onehot(params: HmmParams, sel_t, prev_dev, lens2: torch.Tensor,
                          a0_raw: torch.Tensor, beta0: torch.Tensor, T: int, *,
                          pair_esym=None, fused: bool = True, conf_mask=None):
    """Reduced forward + backward over the [Tp, NL] lane layout.

    a0_raw / beta0 arrive full-K [K, NL] and are projected onto each lane's
    entry / exit group here.  ``pair_esym``: a prepared (pair2, esym2,
    pairn2) stream (esym2 may be None: it is derived from pair2);
    otherwise it is built from ``sel_t`` and ``prev_dev``.  Returns
    (alphas2 [Tp, 2, NL], betas2 [Tp, 2, NL], esym2 [Tp, NL]).

    ``fused`` (the default) runs B4: both chains in one launch, the betas
    SELF-NORMALIZED per-position directions — exact for every scale-free
    consumer (the confidence ratio, the z-normalized counts, the MPM
    argmax), wrong for B12's cs-scaled counts.  ``fused=False`` is the
    split arm: B9, then B10 over ``cs_next`` (:func:`cs_next_of`), the betas
    true Rabiner (cs-scaled).  With ``conf_mask`` ([K] island indicator)
    the second slot is the island confidence [Tp, NL] instead: on the fused
    arm :func:`conf_from_reduced` over B4's streams, on the split arm B11,
    which never stores the betas.  Unlike the JAX runner it returns no
    Rabiner scales: no consumer here reads them."""
    gt = _groups(params)
    pair2, esym2, pairn2 = _streams(params.n_symbols, pair_esym, sel_t, prev_dev)
    a0_red, beta0_red = _reduced_operands(params, gt, esym2, a0_raw, beta0)
    tab_ext = prob_tab_ext(params, gt)
    if fused:
        alphas2, betas2 = oh_fwdbwd(pair2, pairn2, lens2, a0_red, beta0_red, tab_ext, T)
        if conf_mask is not None:
            return alphas2, conf_from_reduced(alphas2, betas2, esym2, lens2, conf_mask,
                                              gt), esym2
        return alphas2, betas2, esym2
    alphas2 = oh_fwd(pair2, lens2, a0_red, tab_ext)
    cs_next = cs_next_of(alphas2)
    if conf_mask is not None:
        mtab = conf_mask.to(_F32)[gt].contiguous()
        return alphas2, oh_bwd_conf(pairn2, pair2, lens2, cs_next, beta0_red, alphas2, mtab,
                                    tab_ext, T), esym2
    return alphas2, oh_bwd(pairn2, lens2, cs_next, beta0_red, tab_ext, T), esym2


def run_fb_mat_onehot(params: HmmParams, lens2: torch.Tensor, T: int, pair_esym):
    """The one-pass arm's one T-scaling pass: B8 over the [Tp, NL] lane
    layout, needing no boundary messages.

    ``pair_esym``: (pair2, esym2 or None, pairn2).  Returns (va,
    wb [Tp, 4, NL], esym2 [Tp, NL], red [NL, 2, 2]).  ``red`` is the lane
    transfer total that B7 gives on the two-pass arm, from an O(NL)
    epilogue: red[n] = M_0(n) . Va[last, n] (position 0's step matrix —
    the identity for a masked init and for empty lanes — times the carried
    product), renormalized by its own total ((r00 + r01) + r10) + r11;
    its directions equal B7's to ~ulp.  Apply the entry directions with
    :func:`contract_mat_streams` once they exist."""
    S = params.n_symbols
    gt = _groups(params)
    tab_ext = prob_tab_ext(params, gt)
    pair2, esym2, pairn2 = pair_esym
    if esym2 is None:
        esym2 = decode_esym(pair2, S)
    va, wb = oh_fwdbwd_mat(pair2, pairn2, lens2, tab_ext, T)
    m0 = tab_ext[torch.clamp_max(pair2[0], S * S).long()]  # [NL, 4]
    ve = va[-1]  # [4, NL]
    r00 = m0[:, 0] * ve[0] + m0[:, 1] * ve[2]
    r01 = m0[:, 0] * ve[1] + m0[:, 1] * ve[3]
    r10 = m0[:, 2] * ve[0] + m0[:, 3] * ve[2]
    r11 = m0[:, 2] * ve[1] + m0[:, 3] * ve[3]
    tot = torch.clamp_min(((r00 + r01) + r10) + r11, 1e-30)
    red = torch.stack([r00, r01, r10, r11], dim=1).reshape(-1, GROUP, GROUP) / tot[:, None, None]
    return va, wb, esym2, red


def contract_mat_streams(va, wb, a0_raw, beta0, gt, esym2):
    """(alphas2, betas2) [Tp, 2, NL] from B8's matrix streams and the entry
    directions: alphas2[t, c] = a0[0] Va[t, 0c] + a0[1] Va[t, 1c] and
    betas2[t, a] = Wb[t, a0] b0[0] + Wb[t, a1] b0[1] — an elementwise
    epilogue, no chain.  ``a0_raw`` / ``beta0`` arrive full-K [K, NL] and
    are projected onto each lane's entry / exit group here.  Both streams
    carry matrix-total scales: their directions match the two-pass
    streams to ~ulp, but the alphas' sums are not the Rabiner c (the loglik
    comes from :func:`mat_loglik_lanes`)."""
    a0 = torch.gather(a0_raw.T, 1, gt[esym2[0].long()]).to(_F32)  # [NL, 2]
    b0 = torch.gather(beta0.T, 1, gt[esym2[-1].long()]).to(_F32)
    alphas2 = torch.stack([a0[:, 0] * va[:, 0] + a0[:, 1] * va[:, 2],
                           a0[:, 0] * va[:, 1] + a0[:, 1] * va[:, 3]], dim=1)
    betas2 = torch.stack([wb[:, 0] * b0[:, 0] + wb[:, 1] * b0[:, 1],
                          wb[:, 2] * b0[:, 0] + wb[:, 3] * b0[:, 1]], dim=1)
    return alphas2, betas2


def mat_loglik_lanes(va, alphas2, lens2):
    """Exact per-lane loglik [1, NL] from the matrix stream (the one-pass
    arm has no Rabiner c for B5 to sum).  The forward renormalizations
    telescope: ll_n = log sum_c alphas2[last, c, n] + sum over t + 1 < l_n
    of log sig_t,n, with sig_t = ((V00 + V01) + V10) + V11 of Va[t] (the
    pass-through makes row Tp-1 the last valid one).  Empty lanes give 0."""
    Tp = va.shape[0]
    sig = ((va[:, 0] + va[:, 1]) + va[:, 2]) + va[:, 3]  # [Tp, NL]
    smask = (torch.arange(Tp, device=va.device)[:, None] + 1) < lens2
    last = torch.log(torch.clamp_min(alphas2[-1, 0] + alphas2[-1, 1], 1e-30))[None, :]
    steps = torch.sum(torch.where(smask, torch.log(torch.clamp_min(sig, 1e-30)), 0.0),
                      dim=0)[None, :]
    return torch.where(lens2 > 0, last + steps, 0.0)


def run_seq_stats_onehot(params: HmmParams, alphas2, betas2, pair2, lens2, gt,
                         enters_red, enters_full, pair0_mask):
    """Z-normalized stats from the reduced streams (power-of-two S).
    Returns (macc [K*K, NL] — trans = A * macc summed over lanes; emit_red
    [2S, NL]; ll [1, NL]).  The chunked caller passes zero enters and an
    all-zero pair0 mask: every lane is a record with no incoming pair."""
    S = params.n_symbols
    if S & (S - 1):
        raise ValueError("run_seq_stats_onehot: power-of-two S only")
    B_red = reduced_emissions(params, gt)
    return oh_seq_stats(alphas2, betas2, pair2, lens2, prob_tab_ext(params, gt), B_red,
                        gt.to(_I32).contiguous(), enters_full, enters_red, pair0_mask)


def beta_scale_of(fused: bool, one_pass: bool = False) -> str:
    """The scale of the betas a forward-backward launch produced: "cs" (the
    split arm: true Rabiner, cs-scaled), "selfnorm" (the fused arm's
    per-position directions) or "matrix" (the one-pass arm's contraction,
    also directions).  Route points pass it to :func:`run_stats_onehot`'s
    ``betas_scale``, so pairing B12 with direction betas raises."""
    if one_pass:
        return "matrix"
    return "selfnorm" if fused else "cs"


def run_stats_onehot(params: HmmParams, alphas2, betas2, pair2, lens2, gt, Tt: int, *,
                     betas_scale: str = "cs"):
    """Chunked counts from the split arm's reduced streams (B12): (macc
    [K*K, NL] — trans = A * macc summed over lanes; emit_red [2S, NL],
    emit_full[gt[s, c], s] = emit_red[2s + c]; ll [1, NL]).  Power-of-two
    S only; callers fall back to the dense stats kernel otherwise.  ``Tt``
    is the TPU layout's tile, kept so the signature is the JAX package's:
    the card's layout does not read it (B12 takes its segments from the
    shape, :func:`stats_segment_t`).

    ``betas_scale`` guards the route: macc is DEGREE 1 in the betas, so
    only "cs" betas (the split backward's) are legal.  "selfnorm" (fused)
    and "matrix" (one-pass) betas are per-position directions and raise:
    those arms route :func:`run_seq_stats_onehot` (z-normalized, scale-free
    in the betas) with zero enters and an all-zero pair0 mask."""
    if betas_scale != "cs":
        raise ValueError(
            f"run_stats_onehot is cs-scaled (macc is degree 1 in the betas) but was routed "
            f"{betas_scale!r} betas: self-normalized directions must pair with the "
            "z-normalized run_seq_stats_onehot (zero enters, all-zero pair0 mask); that "
            "pairing is a bug"
        )
    S = params.n_symbols
    if S & (S - 1):
        raise ValueError(
            "run_stats_onehot takes power-of-two n_symbols only; callers fall back to the "
            "dense stats kernel otherwise"
        )
    return oh_stats(alphas2, betas2, pair2, lens2, reduced_emissions(params, gt),
                    gt.to(_I32).contiguous())


# ---------------------------------------------------------------------------
# The stacked half: B21, B24 and B25 for M members over one pair stream


def check_stacked_members(params_list) -> int:
    """Validate a stacked member set (one alphabet, reduced tables that fit
    the kernels) and return its S."""
    if not params_list:
        raise ValueError("a stacked launch needs at least one member")
    S = params_list[0].n_symbols
    if any(p.n_symbols != S for p in params_list):
        raise ValueError("stacked members must share one alphabet, got n_symbols "
                         f"{[p.n_symbols for p in params_list]}")
    if S > MAX_SYMBOLS or any(p.n_states > GROUP * MAX_SYMBOLS for p in params_list):
        raise ValueError(f"stacked members need at most {MAX_SYMBOLS} symbols and "
                         f"{GROUP * MAX_SYMBOLS} states")
    return S


def stacked_tables(params_list):
    """(group tables [M, S, 2] int64, pair tables [M, S*S + 1, 4] f32) of a
    stacked member set, identity rows last."""
    gts = torch.stack([_groups(p) for p in params_list])
    tabs = torch.stack([prob_tab_ext(p, gt) for p, gt in zip(params_list, gts)])
    return gts, tabs.contiguous()


def _check_stacked_tables(tabs: torch.Tensor) -> int:
    if tabs.dim() != 3 or 0 in tabs.shape:
        raise ValueError(f"stacked tables must be a non-empty [M, nP, 4], got {tuple(tabs.shape)}")
    M = tabs.shape[0]
    _check_table(tabs[0])
    _check("tabs", tabs, _F32, (M, tabs.shape[1], 4))
    return M


def oh_prod_stacked_plain(pair2: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """Plain version of B21 -> [M, 4, NL]: :func:`oh_prod_plain` for every
    member's table ``tabs[m]`` ([M, S*S + 1, 4]), the member axis carried
    through one step loop (per member the same operations; with G > 1,
    through :func:`_prod_sublanes_plain`'s)."""
    G = prod_sublanes(pair2.shape[0])
    if G > 1:
        return _prod_sublanes_plain(pair2, tabs, G)
    nreal = tabs.shape[1] - 1
    M, NL = tabs.shape[0], pair2.shape[1]
    pc = torch.clamp_max(pair2, nreal).long()
    one = torch.ones((M, NL), dtype=_F32, device=pair2.device)
    zero = torch.zeros((M, NL), dtype=_F32, device=pair2.device)
    c00, c01, c10, c11 = one, zero, zero, one
    for t in range(pair2.shape[0]):
        a00, a01, a10, a11 = tabs[:, pc[t]].unbind(-1)  # [M, NL] each
        n00 = c00 * a00 + c01 * a10
        n01 = c00 * a01 + c01 * a11
        n10 = c10 * a00 + c11 * a10
        n11 = c10 * a01 + c11 * a11
        tot = torch.clamp_min(((n00 + n01) + n10) + n11, 1e-30)
        c00, c01, c10, c11 = n00 / tot, n01 / tot, n10 / tot, n11 / tot
    return torch.stack([c00, c01, c10, c11], dim=1)


def oh_prod_stacked(pair2: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """Kernel B21 (replaces ``_oh_prod_stacked_kernel``) -> [M, 4, NL] f32.
    Arguments as :func:`oh_prod_stacked_plain`."""
    _check_same_device(pair2, (tabs,))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    _check("pair2", pair2, _I32, (Tp, NL))
    M = _check_stacked_tables(tabs)
    if pair2.device.type == "cpu":
        return oh_prod_stacked_plain(pair2, tabs)
    out = torch.empty((M, 4, NL), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_prod_stacked", pair2, tabs, out, Tp=Tp, NL=NL,
                    nreal=tabs.shape[1] - 1, G=prod_sublanes(Tp), M=M)
    return out


def products_reduced_stacked(params_list, pair2: torch.Tensor) -> list:
    """Every member's [NL, 2, 2] lane products (:func:`products_reduced`)
    in ONE launch of B21 over the shared pair stream."""
    check_stacked_members(params_list)
    NL = pair2.shape[1]
    red = oh_prod_stacked(pair2, stacked_tables(params_list)[1])
    return [r.T.reshape(NL, GROUP, GROUP) for r in red]


def _stacked_step(tabs: torch.Tensor, pairs_t: torch.Tensor, order) -> torch.Tensor:
    """One step's matrices of every member, [M, 2 (summed index), 2
    (output), NL] (``order`` as in :func:`_step_matrices`)."""
    M, NL = tabs.shape[0], pairs_t.shape[0]
    m = tabs[:, torch.clamp_max(pairs_t, tabs.shape[1] - 1).long()][..., order]  # [M, NL, 4]
    return m.reshape(M, NL, 2, 2).permute(0, 2, 3, 1)


def oh_fwd_stacked_plain(pair2, lens2, a0_red, tabs) -> torch.Tensor:
    """Plain version of B22 -> alphas [M, Tp, 2, NL]: :func:`oh_fwd_plain`
    for every member (a0_red [M, 2, NL], tabs [M, S*S + 1, 4]), the member
    axis carried through one step loop (per member the same operations; in
    G > 1 through :func:`_fwd_sublanes_plain`'s).  In one sub-lane the twin
    of ``_xla_fwd_onehot_stacked``."""
    Tp = pair2.shape[0]
    G = sublanes(Tp)
    if G > 1:
        return _fwd_sublanes_plain(pair2, lens2, a0_red, tabs, G)
    valid = (torch.arange(Tp, device=pair2.device)[:, None] < lens2).unbind(0)
    alphas = [a0_red]
    for t in range(1, Tp):
        v = alphas[-1]
        inv = torch.reciprocal(v.sum(1))
        raw = (v[:, :, None, :] * _stacked_step(tabs, pair2[t], [0, 1, 2, 3])).sum(1)
        alphas.append(torch.where(valid[t], raw * inv[:, None], v))
    return torch.stack(alphas, dim=1)


def _bwd_stacked_plain(pairn2, lens2, beta0_red, tabs, T: int, cs_next=None) -> torch.Tensor:
    """:func:`_bwd_plain` for every member (beta0_red [M, 2, NL], cs_next
    [M, Tp, NL] or None), the member axis carried through one step loop."""
    Tp = pairn2.shape[0]
    steps = torch.arange(Tp, device=pairn2.device)[:, None]
    keep = ((steps <= T - 2) & (steps + 1 < lens2)).unbind(0)
    inv_c = None if cs_next is None else torch.reciprocal(cs_next).unbind(1)
    betas = [beta0_red]
    for tb in range(Tp - 1, -1, -1):
        bn = betas[-1]
        scale = torch.reciprocal(bn.sum(1)) if inv_c is None else inv_c[tb]
        b = (bn[:, :, None, :] * _stacked_step(tabs, pairn2[tb], [0, 2, 1, 3])).sum(1) * \
            scale[:, None]
        betas.append(torch.where(keep[tb], b, bn))
    return torch.stack(betas[:0:-1], dim=1)


def oh_bwd_stacked_plain(pairn2, lens2, cs_next, beta0_red, tabs, T: int) -> torch.Tensor:
    """Plain version of B23 -> betas [M, Tp, 2, NL]: :func:`oh_bwd_plain`
    for every member (cs_next [M, Tp, NL], beta0_red [M, 2, NL]), in G > 1
    through :func:`_split_bwd_sublanes_plain`.  In one sub-lane the twin of
    ``_xla_bwd_onehot_stacked``."""
    G = split_bwd_sublanes(pairn2.shape[0])
    if G > 1:
        return _split_bwd_sublanes_plain(pairn2, lens2, cs_next, beta0_red, tabs, T, G)
    return _bwd_stacked_plain(pairn2, lens2, beta0_red, tabs, T, cs_next=cs_next)


def oh_fwdbwd_stacked_plain(pair2, pairn2, lens2, a0_red, beta0_red, tabs, T: int):
    """Plain version of B24 -> (alphas [M, Tp, 2, NL], betas [M, Tp, 2,
    NL]): :func:`oh_fwdbwd_plain` for every member (a0_red / beta0_red
    [M, 2, NL], tabs [M, S*S + 1, 4]), the member axis carried through one
    step loop per direction (with G > 1, through
    :func:`_fwdbwd_sublanes_plain`'s loops)."""
    G = sublanes(pair2.shape[0])
    if G > 1:
        return _fwdbwd_sublanes_plain(pair2, pairn2, lens2, a0_red, beta0_red, tabs, T, G)
    return (oh_fwd_stacked_plain(pair2, lens2, a0_red, tabs),
            _bwd_stacked_plain(pairn2, lens2, beta0_red, tabs, T))


def oh_fwdbwd_stacked(pair2, pairn2, lens2, a0_red, beta0_red, tabs, T: int):
    """Kernel B24 (replaces ``_oh_fwdbwd_stacked_kernel``) -> (alphas,
    betas), each [M, Tp, 2, NL] f32; member m's equal B4's on its own
    operands.  Arguments as :func:`oh_fwdbwd_stacked_plain`."""
    _check_same_device(pair2, (pairn2, lens2, a0_red, beta0_red, tabs))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    M = _check_stacked_tables(tabs)
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("pairn2", pairn2, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check("a0_red", a0_red, _F32, (M, GROUP, NL))
    _check("beta0_red", beta0_red, _F32, (M, GROUP, NL))
    G = sublanes(Tp)
    if pair2.device.type == "cpu":
        return oh_fwdbwd_stacked_plain(pair2, pairn2, lens2, a0_red, beta0_red, tabs, T)
    alphas = torch.empty((M, Tp, GROUP, NL), dtype=_F32, device=pair2.device)
    betas = torch.empty((M, Tp, GROUP, NL), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_fwdbwd_stacked", pair2, pairn2, lens2, a0_red, beta0_red, tabs,
                    alphas, betas, Tp=Tp, NL=NL, nreal=tabs.shape[1] - 1, T=T, G=G, M=M)
    return alphas, betas


def _check_stacked_chain(pairs, lens2, tabs, others) -> tuple:
    """(Tp, NL, M) of a stacked chain launch, its operands checked."""
    _check_same_device(pairs, (lens2, tabs, *others))
    if pairs.dim() != 2 or 0 in pairs.shape:
        raise ValueError(f"pair stream must be a non-empty [Tp, NL], got {tuple(pairs.shape)}")
    Tp, NL = pairs.shape
    M = _check_stacked_tables(tabs)
    _check("pairs", pairs, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    return Tp, NL, M


def oh_fwd_stacked(pair2, lens2, a0_red, tabs) -> torch.Tensor:
    """Kernel B22 (replaces ``_oh_fwd_stacked_kernel``): B9 with a member
    grid dimension -> alphas [M, Tp, 2, NL] f32; member m's equal B9's on
    its own operands (the same sub-lanes).  Arguments as
    :func:`oh_fwd_stacked_plain`."""
    Tp, NL, M = _check_stacked_chain(pair2, lens2, tabs, (a0_red,))
    _check("a0_red", a0_red, _F32, (M, GROUP, NL))
    if pair2.device.type == "cpu":
        return oh_fwd_stacked_plain(pair2, lens2, a0_red, tabs)
    return _launch_fwd(pair2, lens2, a0_red, tabs, stacked=True)


def oh_bwd_stacked(pairn2, lens2, cs_next, beta0_red, tabs, T: int) -> torch.Tensor:
    """Kernel B23 (replaces ``_oh_bwd_stacked_kernel``): B10 with a member
    grid dimension -> betas [M, Tp, 2, NL] f32; member m's equal B10's on
    its own operands (the same sub-lanes).  Arguments as
    :func:`oh_bwd_stacked_plain`."""
    Tp, NL, M = _check_stacked_chain(pairn2, lens2, tabs, (cs_next, beta0_red))
    _check("cs_next", cs_next, _F32, (M, Tp, NL))
    _check("beta0_red", beta0_red, _F32, (M, GROUP, NL))
    if pairn2.device.type == "cpu":
        return oh_bwd_stacked_plain(pairn2, lens2, cs_next, beta0_red, tabs, T)
    return _launch_bwd(pairn2, lens2, cs_next, beta0_red, tabs, T, stacked=True)


def run_fb_kernels_onehot_stacked(params_list, lens2: torch.Tensor, a0_raws, beta0s, T: int,
                                  *, pair_esym, fused: bool = True, conf_masks=None):
    """:func:`run_fb_kernels_onehot` for M members over ONE shared
    prepared stream ``pair_esym`` = (pair2, esym2 or None, pairn2): one
    launch of B24 (``fused``, the betas self-normalized), or of B22 and one
    of B23 (the split arm, the betas cs-scaled).  ``a0_raws`` / ``beta0s``:
    per-member [K_m, NL] entering vectors.  Returns (alphas [M, Tp, 2, NL],
    betas [M, Tp, 2, NL], esym2); with ``conf_masks`` (per-member [K_m]
    island indicators) the second slot is the list of per-member
    confidences [Tp, NL] (:func:`conf_from_reduced`, on both arms)."""
    S = check_stacked_members(params_list)
    pair2, esym2, pairn2 = _streams(S, pair_esym, None, None)
    gts, tabs = stacked_tables(params_list)
    reds = [_reduced_operands(p, gt, esym2, a0, b0)
            for p, gt, a0, b0 in zip(params_list, gts, a0_raws, beta0s)]
    a0_st = torch.stack([a for a, _ in reds])
    b0_st = torch.stack([b for _, b in reds])
    if fused:
        alphas, betas = oh_fwdbwd_stacked(pair2, pairn2, lens2, a0_st, b0_st, tabs, T)
    else:
        alphas = oh_fwd_stacked(pair2, lens2, a0_st, tabs)
        betas = oh_bwd_stacked(pairn2, lens2, cs_next_of(alphas), b0_st, tabs, T)
    if conf_masks is None:
        return alphas, betas, esym2
    confs = [conf_from_reduced(alphas[m], betas[m], esym2, lens2, conf_masks[m], gts[m])
             for m in range(len(params_list))]
    return alphas, confs, esym2


def oh_seq_stats_stacked_plain(alphas2, betas2, pair2, lens2, tabs, B_reds, gts, enters_full,
                               enters_red, pair0m):
    """Plain version of B25 -> (macc [M, K*K, NL], emit_red [M, 2S, NL],
    ll [M, 1, NL]): :func:`oh_seq_stats_plain` run for each member of the
    member-major operands (the JAX twin loops ``_xla_znorm_stats`` the same
    way: time reductions, no step loop)."""
    outs = [oh_seq_stats_plain(alphas2[m], betas2[m], pair2, lens2, tabs[m], B_reds[m], gts[m],
                               enters_full[m], enters_red[m], pair0m)
            for m in range(tabs.shape[0])]
    return tuple(_stack_keeping_strides(x) for x in zip(*outs))


def _stack_keeping_strides(xs) -> torch.Tensor:
    """Stack equal-shaped dense tensors along a new leading axis so that each
    member's slice keeps the strides of its own tensor: a later reduction
    over the slice then runs in the same order as over the single-model
    output (on the CPU, ``torch.sum`` orders its terms by memory layout)."""
    x0 = xs[0]
    out = torch.empty_strided((len(xs),) + tuple(x0.shape), (x0.numel(),) + x0.stride(),
                              dtype=x0.dtype, device=x0.device)
    for o, x in zip(out, xs):
        o.copy_(x)
    return out


def oh_seq_stats_stacked(alphas2, betas2, pair2, lens2, tabs, B_reds, gts, enters_full,
                         enters_red, pair0m):
    """Kernel B25 (replaces ``_oh_seq_stats_stacked_kernel``): B5 with a
    member grid dimension -> (macc [M, K*K, NL], emit_red [M, 2S, NL], ll
    [M, 1, NL]).  Arguments member-major versions of :func:`oh_seq_stats`'s;
    every member has the same K = 2S."""
    _check_same_device(pair2, (alphas2, betas2, lens2, tabs, B_reds, gts, enters_full,
                               enters_red, pair0m))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    M = _check_stacked_tables(tabs)
    S = gts.shape[1]
    K = enters_full.shape[1]
    if K != GROUP * S or tabs.shape[1] != S * S + 1:
        raise ValueError(f"{K} states, {tabs.shape[1]} table rows for {S} symbols: the reduced "
                         "stats need K == 2S and S*S + 1 rows")
    _check("alphas2", alphas2, _F32, (M, Tp, GROUP, NL))
    _check("betas2", betas2, _F32, (M, Tp, GROUP, NL))
    _check("pair2", pair2, _I32, (Tp, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check("B_reds", B_reds, _F32, (M, S, GROUP))
    _check("gts", gts, _I32, (M, S, GROUP))
    _check("enters_full", enters_full, _F32, (M, K, NL))
    _check("enters_red", enters_red, _F32, (M, GROUP, NL))
    _check("pair0m", pair0m, _F32, (1, NL))
    if pair2.device.type == "cpu":
        return oh_seq_stats_stacked_plain(alphas2, betas2, pair2, lens2, tabs, B_reds, gts,
                                          enters_full, enters_red, pair0m)
    dev = pair2.device
    rows = 4 * S * S + 2 * S + 1
    part = torch.empty((M, _stats_part_rows(Tp, NL, S), rows, NL), dtype=_F32, device=dev)
    macc = torch.empty((M, K * K, NL), dtype=_F32, device=dev)
    emit_red = torch.empty((M, 2 * S, NL), dtype=_F32, device=dev)
    ll = torch.empty((M, 1, NL), dtype=_F32, device=dev)
    _kernels.launch("oh_seq_stats_stacked", alphas2, betas2, pair2, lens2, tabs, B_reds, gts,
                    enters_full, enters_red, pair0m, part, macc, emit_red, ll,
                    Tp=Tp, NL=NL, S=S, K=K, Tt=stats_segment_t(Tp, NL),
                    SPB=stats_segments_per_block(S), M=M)
    return macc, emit_red, ll


def reduced_emissions(params: HmmParams, gt) -> torch.Tensor:
    """B_red [S, 2]: each group member's probability of emitting its symbol."""
    S = params.n_symbols
    return params.B.to(_F32)[gt, torch.arange(S, device=gt.device)[:, None]].contiguous()


def run_seq_stats_onehot_stacked(params_list, alphas2, betas2, pair2, lens2, enters_red,
                                 enters_full, pair0_mask) -> list:
    """:func:`run_seq_stats_onehot` for M members of one K (and a
    power-of-two S) in one launch of B25, over the member-major streams of
    :func:`run_fb_kernels_onehot_stacked` (enters_red [M, 2, NL],
    enters_full [M, K, NL]).  Returns per-member (macc, emit_red, ll)."""
    S = check_stacked_members(params_list)
    if S & (S - 1):
        raise ValueError("run_seq_stats_onehot_stacked: power-of-two S only")
    if len({p.n_states for p in params_list}) != 1:
        raise ValueError("the stacked stats kernel needs one common n_states, got "
                         f"{[p.n_states for p in params_list]}")
    gts, tabs = stacked_tables(params_list)
    B_reds = torch.stack([reduced_emissions(p, gt) for p, gt in zip(params_list, gts)])
    macc, emit_red, ll = oh_seq_stats_stacked(alphas2, betas2, pair2, lens2, tabs, B_reds,
                                              gts.to(_I32).contiguous(), enters_full,
                                              enters_red, pair0_mask)
    # Each member's counts in an allocation of their own, as a single-model
    # launch returns them: PyTorch's CUDA reductions vectorize only from an
    # aligned start, so a sum over a member's slice of the stacked buffer
    # could add in another order than over its own launch's output.
    return [tuple(x[m].clone() for x in (macc, emit_red, ll)) for m in range(len(params_list))]
