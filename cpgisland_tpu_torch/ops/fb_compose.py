"""Pair composition of the reduced forward chain: the streams, the tables,
the CUDA kernels and their plain PyTorch versions.

Counterpart of the four forward lowerings of ``tools/bench_compose.py``
(the JAX package's microbenchmark; its helpers are closures inside its
``main``, written here as module-level functions).  Every variant takes the
flagship's pair table ``tab`` [S*S, 4] (:func:`fb_onehot.prob_pair_table`),
a time-major pair stream ``pair2`` [Tp, NL] int32 whose every pair is real
(< S*S) and chains (pair t's current symbol is pair t+1's previous one),
``lens2`` [1, NL] int32 and the entering vectors ``a0_red`` [2, NL] f32 —
the layout of B9 — and returns the alphas [Tp, 2, NL] f32 of B9's forward
chain (deferred scaling, the entering vector at t == 0, carried past a
lane's length).

- T1 ``single`` needs no function here: it is B9, :func:`fb_onehot.oh_fwd`
  with :func:`fb_onehot.prob_tab_ext`.
- T2 :func:`oh_fwd_strm` (replaces ``_fwd_strm_kernel``): B9's chain with
  the four entries of each step's 2x2 matrix streamed from device memory
  (:func:`mat_streams`) instead of looked up in the kernel, in B9's
  sub-lanes (``fb_onehot.sublanes(Tp)``) with B9's operations in B9's
  order.  Its alphas equal B9's bit for bit at every G.
- T3 :func:`oh_fwd_comp` (replaces ``_fwd_comp_kernel``): the double-step
  chain.  Double step h covers steps 2h and 2h + 1: the carried alpha
  takes alpha_{2h+1} = (v . T2_h) / (v . R_h) with T2_h = T_{2h} T_{2h+1}
  precomposed and R_h the row sums of T_{2h}, while the intermediate
  alpha_{2h} = (v . T_{2h}) / (v0 + v1) hangs off the chain.  The same
  real arithmetic as the single-step chain, rounded elsewhere.  Ten
  streams (:func:`composed_streams`): T2, R and T_even.  It runs in B9's
  G = ``fb_onehot.sublanes(Tp)`` sub-lanes of ceil(H / G) double steps
  (:func:`_comp_sublanes_plain`), one chain at G = 1.
- T4 :func:`oh_fwd_compsel` (replaces ``_fwd_compsel_kernel``): T3's
  chain, in T3's sub-lanes at T3's G, with the composed matrices looked up
  in the kernel from the tables of :func:`composed_tables`, keyed by two
  index streams (:func:`compsel_index`).  Its table rows are built with
  T3's own elementwise formula, so on chained pairs its alphas equal T3's
  bit for bit at every G.

Each lane's double step 0 takes an identity even half: alpha_0 is the
entering vector, so only T_1 applies there.  The composed variants need an
even Tp; the functions that build their streams raise otherwise.

Each wrapper takes the plain version for a CPU tensor, launches its kernel
(``csrc/fb_onehot.cu``) for a CUDA tensor, and raises otherwise.
"""

from __future__ import annotations

import math

import torch

from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops import fb_onehot as FB
from cpgisland_tpu_torch.ops.fb_onehot import PROB_IDENT, _check_same_device, fwd_chain_plain
from cpgisland_tpu_torch.ops.viterbi_onehot import GROUP, _check

_I32 = torch.int32
_F32 = torch.float32

N_COMP = 10  # composed streams: T2 (4 entries), R (2), T_even (4)
# Largest alphabet T4 takes: its three tables sit in the kernel's shared
# memory (S*S*(S+1) + S*S composed rows).
MAX_COMP_SYMBOLS = 8


def _n_symbols(tab: torch.Tensor) -> int:
    S = math.isqrt(tab.shape[0]) if tab.dim() == 2 and tab.shape[1] == 4 else 0
    if S == 0 or S * S != tab.shape[0] or tab.dtype != _F32:
        raise ValueError(f"tab must be an f32 pair table [S*S, 4], got {tab.dtype} "
                         f"{tuple(tab.shape)}")
    return S


def _halves(pair2: torch.Tensor):
    if pair2.dim() != 2 or 0 in pair2.shape or pair2.shape[0] % 2:
        raise ValueError(f"the composed chain needs an even, non-empty Tp: pair2 "
                         f"{tuple(pair2.shape)}")
    return pair2[0::2], pair2[1::2]


def mat_streams(tab: torch.Tensor, pair2: torch.Tensor) -> torch.Tensor:
    """T2's streams [4, Tp, NL]: entry k of step t's matrix, tab[pair2[t], k]
    (``mat_stream`` of the JAX script; one [Tp, NL] row per entry keeps the
    lanes minor)."""
    _n_symbols(tab)
    return tab.T[:, pair2.long()].contiguous()


def _compose(ge: torch.Tensor, go: torch.Tensor) -> torch.Tensor:
    """Entrywise 2x2 product ge . go over a leading axis of 4 entries
    (00, 01, 10, 11): one multiply, one multiply, one add, each rounded."""
    return torch.stack([ge[0] * go[0] + ge[1] * go[2], ge[0] * go[1] + ge[1] * go[3],
                        ge[2] * go[0] + ge[3] * go[2], ge[2] * go[1] + ge[3] * go[3]])


def _row_sums(ge: torch.Tensor) -> torch.Tensor:
    return torch.stack([ge[0] + ge[1], ge[2] + ge[3]])


def composed_streams(tab: torch.Tensor, pair2: torch.Tensor) -> torch.Tensor:
    """T3's streams [10, Tp/2, NL]: rows 0-3 T2 = T_even . T_odd, rows 4-5 R
    = the row sums of T_even, rows 6-9 T_even itself; double step 0's even
    half is the identity."""
    _n_symbols(tab)
    even, odd = _halves(pair2)
    tabT = tab.T
    ge = tabT[:, even.long()]  # [4, H, NL]
    go = tabT[:, odd.long()]
    ge[:, 0] = torch.tensor(PROB_IDENT, dtype=_F32, device=tab.device)[:, None]
    return torch.cat([_compose(ge, go), _row_sums(ge), ge]).contiguous()


def composed_tables(tab: torch.Tensor):
    """T4's tables -> (t2tab [S*S*(S+1) + S*S, 4], rtab [S*S+1, 2], ttab
    [S*S+1, 4]), the JAX script's ``comp_tables``.

    t2tab row p*(S+1) + q is tab[p] . tab[(p mod S)*S + q] for q < S and
    tab[p] for q == S (an identity odd half); row S*S*(S+1) + p is tab[p]
    (an identity even half: double step 0).  Each row is built by T3's
    elementwise formula (:func:`_compose`), the identity halves included,
    so a looked-up row equals the streamed T2 of the same pairs bit for
    bit; the script's f32 matmul agrees within one ulp.  rtab holds each
    pair's row sums and ttab the pair table, with the identity's (ones, and
    the identity) as row S*S."""
    S = _n_symbols(tab)
    dev = tab.device
    ident = torch.tensor(PROB_IDENT, dtype=_F32, device=dev)
    ext = torch.cat([tab, ident[None, :]])  # row S*S: the identity
    p = torch.arange(S * S, device=dev)
    q = torch.arange(S + 1, device=dev)
    odd = torch.where(q[None, :] < S, (p[:, None] % S) * S + q[None, :], S * S)  # [S*S, S+1]
    rows = _compose(tab.repeat_interleave(S + 1, dim=0).T, ext[odd.reshape(-1)].T)
    first = _compose(ident[:, None].expand(4, S * S), tab.T)
    t2tab = torch.cat([rows.T, first.T]).contiguous()
    ones = torch.ones((1, 2), dtype=_F32, device=dev)
    rtab = torch.cat([_row_sums(tab.T).T, ones]).contiguous()
    return t2tab, rtab, ext.contiguous()


def compsel_index(pair2: torch.Tensor, S: int) -> torch.Tensor:
    """T4's index streams [2, Tp/2, NL] int32: row 0 trip = pair_even *
    (S+1) + pair_odd mod S (t2tab's row), row 1 the even pair (rtab's and
    ttab's row); double step 0 takes the identity even half (trip
    S*S*(S+1) + pair_1, paire S*S)."""
    even, odd = _halves(pair2)
    trip = even * (S + 1) + odd % S
    trip[0] = S * S * (S + 1) + odd[0]
    pe = even.clone()
    pe[0] = S * S
    return torch.stack([trip, pe]).to(_I32).contiguous()


# ---------------------------------------------------------------------------
# The plain versions


def _mat_steps(mats: torch.Tensor):
    """The step source of four streamed planes ``mats`` [4, rows, NL] (T2's
    matrices, T3's composed T2 rows): rows_k [G] -> the four entries [1, G,
    NL] of each sub-lane's step at rows_k."""
    return lambda rows_k: mats[:, rows_k][:, None].unbind(0)


def oh_fwd_strm_plain(mats: torch.Tensor, lens2: torch.Tensor,
                      a0_red: torch.Tensor) -> torch.Tensor:
    """Plain version of T2 -> alphas2 [Tp, 2, NL]: B9's plain version over
    the streamed matrices ``mats`` [4, Tp, NL], so it equals
    :func:`fb_onehot.oh_fwd_plain` on the same pairs bit for bit.  In G =
    ``fb_onehot.sublanes(Tp)`` sub-lanes B9's body
    :func:`fb_onehot.fwd_sublanes_plain`; at G = 1 its chain
    :func:`fb_onehot.fwd_chain_plain` (the same operations in the same
    order)."""
    Tp, NL = mats.shape[1:]
    G = FB.sublanes(Tp)
    if G > 1:
        return FB.fwd_sublanes_plain(_mat_steps(mats), Tp, lens2, a0_red[None], G)[0]
    fwd = mats.reshape(GROUP, GROUP, Tp, NL).permute(2, 0, 1, 3).unbind(0)
    return fwd_chain_plain(fwd, lens2, a0_red)


def oh_fwd_comp_plain(comp: torch.Tensor, lens2: torch.Tensor,
                      a0_red: torch.Tensor) -> torch.Tensor:
    """Plain version of T3 -> alphas2 [2H, 2, NL] over the composed
    streams ``comp`` [10, H, NL]: in G = ``fb_onehot.sublanes(2H)``
    sub-lanes :func:`_comp_sublanes_plain`, at G = 1 the one chain
    :func:`_comp_chain_plain`."""
    G = FB.sublanes(2 * comp.shape[1])
    if G > 1:
        return _comp_sublanes_plain(comp, lens2, a0_red, G)
    return _comp_chain_plain(comp, lens2, a0_red)


def _comp_chain_plain(comp: torch.Tensor, lens2: torch.Tensor,
                      a0_red: torch.Tensor) -> torch.Tensor:
    """T3 (and T4) in one chain -> alphas2 [2H, 2, NL]: the chain of
    ``_fwd_comp_kernel`` op for op, over [2, NL] tensors, one Python step a
    double step (t = 2h, v the carry): inv = 1 / (v0 + v1); w = v . TE; i =
    where(t < len, w * inv, v), the entering vector at t == 0; den = v . R;
    u = v . T2; n = where(t + 1 < len, u * (1 / den), i).  Writes i at 2h
    and n at 2h + 1, and carries n."""
    H, NL = comp.shape[1:]
    t2 = comp[0:4].reshape(GROUP, GROUP, H, NL).permute(2, 0, 1, 3).unbind(0)
    rr = comp[4:6].permute(1, 0, 2).unbind(0)
    te = comp[6:10].reshape(GROUP, GROUP, H, NL).permute(2, 0, 1, 3).unbind(0)
    t = torch.arange(0, 2 * H, 2, device=comp.device)[:, None]
    act0 = (t < lens2).unbind(0)
    act1 = (t + 1 < lens2).unbind(0)
    v = a0_red
    alphas = []
    for h in range(H):
        inv = torch.reciprocal(v.sum(0))
        w = (v[:, None, :] * te[h]).sum(0)
        i = a0_red if h == 0 else torch.where(act0[h], w * inv, v)
        den = (v * rr[h]).sum(0)
        u = (v[:, None, :] * t2[h]).sum(0)
        v = torch.where(act1[h], u * torch.reciprocal(den), i)
        alphas += [i, v]
    return torch.stack(alphas)


def _comp_sublanes_plain(comp: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor,
                         G: int) -> torch.Tensor:
    """T3 in G sub-lanes -> alphas2 [2H, 2, NL], the kernel's three phases
    with its f32 operations in its order.  Sub-lane g covers double steps
    [g Lh, min((g + 1) Lh, H)), Lh = ceil(H / G), carried side by side as
    a [G, NL] axis:
    1. each sub-lane's product of its composed matrices T2_h (rows 0-3)
       from the identity, scaled after every 8th double step
       (:func:`fb_onehot._valid_products`; double step 0's even half is the
       identity, so T2_0 = T_1);
    2. the entering directions, from a0 through (v . P) / total sub-lane by
       sub-lane in order (:func:`fb_onehot._direction_messages`; only those
       of sub-lanes up to the one holding a lane's last valid step are
       read, and below it every double step is valid);
    3. :func:`_comp_chain_plain`'s step over every sub-lane from its
       direction (the chain is degree 0 in v); past the last valid step
       max(min(len, Tp), 1) - 1 every alpha is that step's.
    In exact arithmetic these are the one chain's alphas."""
    H, NL = comp.shape[1:]
    Tp = 2 * H
    Lh, h, real, rows = FB._sublane_grid(H, G, comp.device)
    P = FB._valid_products(_mat_steps(comp[0:4]), (1, G, NL), real[:, :, None], real, rows)
    has = torch.ones((G, 1), dtype=torch.bool, device=comp.device)
    m0, m1 = FB._direction_messages(a0_red[None, 0], a0_red[None, 1], P, has, range(G), True)
    v0, v1 = m0[0], m1[0]  # [G, NL]
    lens = lens2[0]
    alphas = []
    for k in range(Lh):
        c = comp[:, rows[:, k]]  # [10, G, NL]
        t = 2 * h[:, k, None]  # [G, 1]
        inv = torch.reciprocal(v0 + v1)
        w0, w1 = v0 * c[6] + v1 * c[8], v0 * c[7] + v1 * c[9]
        act0 = t < lens
        i0 = torch.where(t == 0, a0_red[0], torch.where(act0, w0 * inv, v0))
        i1 = torch.where(t == 0, a0_red[1], torch.where(act0, w1 * inv, v1))
        den = v0 * c[4] + v1 * c[5]
        u0, u1 = v0 * c[0] + v1 * c[2], v0 * c[1] + v1 * c[3]
        dinv = torch.reciprocal(den)
        act1 = t + 1 < lens
        v0, v1 = torch.where(act1, u0 * dinv, i0), torch.where(act1, u1 * dinv, i1)
        alphas.append(torch.stack([torch.stack([i0, i1], 1), torch.stack([v0, v1], 1)], 1))
    # [Lh, G, 2 (i, n), 2, NL] -> [G, Lh, 2, 2, NL] -> rows in step order
    al = torch.stack(alphas).transpose(0, 1).reshape(G * Lh * 2, 2, NL)[:Tp]
    return FB.carry_past_last(al[None], lens)[0]


def _gather_comp(idx: torch.Tensor, t2tab: torch.Tensor, rtab: torch.Tensor,
                 ttab: torch.Tensor) -> torch.Tensor:
    """The [10, H, NL] composed streams that T4's index streams select (the
    indices clamped into the tables, as the kernel clamps them).  The clamp
    is a guard of the port alone: the JAX bench's ``_sel_rows`` selects zero
    rows for an index outside a table.  :func:`compsel_index` never makes
    one, so on the bench's inputs the two agree."""
    trip = idx[0].clamp(0, t2tab.shape[0] - 1).long()
    pe = idx[1].clamp(0, rtab.shape[0] - 1).long()
    return torch.cat([t2tab.T[:, trip], rtab.T[:, pe], ttab.T[:, pe]])


def oh_fwd_compsel_plain(idx: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor,
                         t2tab: torch.Tensor, rtab: torch.Tensor,
                         ttab: torch.Tensor) -> torch.Tensor:
    """Plain version of T4 -> alphas2 [2H, 2, NL]: T3's plain version
    (:func:`oh_fwd_comp_plain`, sub-lanes at ``fb_onehot.sublanes(2H)``)
    over the rows that ``idx`` [2, H, NL] selects from the tables of
    :func:`composed_tables`."""
    return oh_fwd_comp_plain(_gather_comp(idx, t2tab, rtab, ttab), lens2, a0_red)


# ---------------------------------------------------------------------------
# The wrappers


def _check_lanes(x: torch.Tensor, rows: int, dtype, lens2, a0_red, tables=()) -> tuple:
    """Device, type, shape and contiguity of a variant's operands ->
    (steps, NL) of its [rows, steps, NL] stream ``x``."""
    _check_same_device(x, (lens2, a0_red, *tables))
    if x.dim() != 3 or x.shape[0] != rows or 0 in x.shape:
        raise ValueError(f"expected a non-empty [{rows}, steps, NL] stream, got {tuple(x.shape)}")
    _, steps, NL = x.shape
    _check("stream", x, dtype, (rows, steps, NL))
    _check("lens2", lens2, _I32, (1, NL))
    _check("a0_red", a0_red, _F32, (GROUP, NL))
    return steps, NL


def oh_fwd_strm(mats: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor) -> torch.Tensor:
    """Kernel T2 (replaces ``tools/bench_compose.py::_fwd_strm_kernel``) ->
    alphas2 [Tp, 2, NL] f32, the lane in B9's ``fb_onehot.sublanes(Tp)``
    sub-lanes (their products in a [G, 4, NL] scratch).  Arguments as
    :func:`oh_fwd_strm_plain`."""
    Tp, NL = _check_lanes(mats, 4, _F32, lens2, a0_red)
    if mats.device.type == "cpu":
        return oh_fwd_strm_plain(mats, lens2, a0_red)
    G = FB.sublanes(Tp)
    alphas = torch.empty((Tp, GROUP, NL), dtype=_F32, device=mats.device)
    pbuf = torch.empty((G, 4, NL) if G > 1 else (1,), dtype=_F32, device=mats.device)
    _kernels.launch("oh_fwd_strm", mats, lens2, a0_red, alphas, pbuf, Tp=Tp, NL=NL, G=G)
    return alphas


def oh_fwd_comp(comp: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor) -> torch.Tensor:
    """Kernel T3 (replaces ``tools/bench_compose.py::_fwd_comp_kernel``) ->
    alphas2 [2H, 2, NL] f32, the lane in B9's ``fb_onehot.sublanes(2H)``
    sub-lanes (their products in a [G, 4, NL] scratch).  Arguments as
    :func:`oh_fwd_comp_plain`."""
    H, NL = _check_lanes(comp, N_COMP, _F32, lens2, a0_red)
    if comp.device.type == "cpu":
        return oh_fwd_comp_plain(comp, lens2, a0_red)
    G = FB.sublanes(2 * H)
    alphas = torch.empty((2 * H, GROUP, NL), dtype=_F32, device=comp.device)
    pbuf = torch.empty((G, 4, NL) if G > 1 else (1,), dtype=_F32, device=comp.device)
    _kernels.launch("oh_fwd_comp", comp, lens2, a0_red, alphas, pbuf, H=H, NL=NL, G=G)
    return alphas


def oh_fwd_compsel(idx: torch.Tensor, lens2: torch.Tensor, a0_red: torch.Tensor,
                   t2tab: torch.Tensor, rtab: torch.Tensor, ttab: torch.Tensor) -> torch.Tensor:
    """Kernel T4 (replaces ``tools/bench_compose.py::_fwd_compsel_kernel``)
    -> alphas2 [2H, 2, NL] f32, the lane in T3's ``fb_onehot.sublanes(2H)``
    sub-lanes (their products in a [G, 4, NL] scratch).  Arguments as
    :func:`oh_fwd_compsel_plain`; the tables are those of
    :func:`composed_tables` for S <= MAX_COMP_SYMBOLS symbols (the kernel
    keeps them in shared memory)."""
    H, NL = _check_lanes(idx, 2, _I32, lens2, a0_red, (t2tab, rtab, ttab))
    S = math.isqrt(rtab.shape[0] - 1)
    n_pe = S * S + 1
    _check("rtab", rtab, _F32, (n_pe, 2))
    _check("ttab", ttab, _F32, (n_pe, 4))
    _check("t2tab", t2tab, _F32, (S * S * (S + 2), 4))
    if not 1 <= S <= MAX_COMP_SYMBOLS:
        raise ValueError(f"composed tables of {S} symbols: at most {MAX_COMP_SYMBOLS}")
    if idx.device.type == "cpu":
        return oh_fwd_compsel_plain(idx, lens2, a0_red, t2tab, rtab, ttab)
    G = FB.sublanes(2 * H)
    alphas = torch.empty((2 * H, GROUP, NL), dtype=_F32, device=idx.device)
    pbuf = torch.empty((G, 4, NL) if G > 1 else (1,), dtype=_F32, device=idx.device)
    _kernels.launch("oh_fwd_compsel", idx, lens2, a0_red, t2tab, rtab, ttab, alphas, pbuf, H=H,
                    NL=NL, S=S, G=G)
    return alphas
