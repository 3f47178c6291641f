"""The scoring pass: a record's log-likelihood log P(obs | model), lane-parallel.

Counterpart of ``cpgisland_tpu/ops/forward_backward.py::sequence_loglik``,
the scoring entry of the model comparison (``family.compare``).  The JAX
function is one serial scan over the whole record; on the card a 64 Mi
record would be one chain of 64 Mi dependent steps.  Here the record is cut
into the posterior's lanes, and the sum is exact in arithmetic:

1. each lane's normalized transfer operator over its steps: B7
   (``fb_onehot.products_reduced``) for reduced models, B17
   (``fb_pallas._run_products_kernel``) for dense ones;
2. a scan over the lanes gives each lane's exact entering alpha
   direction (``fb_seq._scan``);
3. a forward-only chain per lane from that direction sums log c_t, where
   c_t = sum(alpha_{t-1} . M_t) with alpha_{t-1} normalized is P(o_t |
   o_<t): :func:`oh_loglik` (reduced, pair stream) or :func:`fb_loglik`
   (dense, symbol stream), kernels of ``csrc/loglik.cu``.  A lane of 8 Ki
   steps or more (the posterior's lanes, and every placed record of
   ``compare``) runs as :func:`loglik_sublanes` sub-lanes in the same
   launch: each sub-lane's product of its step matrices, then each
   sub-lane's entering direction composed in order from the lane's
   through the products before it and normalized once, then each
   sub-lane's chain from it, its float64 sums added in order
   (:func:`_oh_loglik_sublanes_plain`, :func:`_fb_loglik_sublanes_plain`).
   The chain is degree 0 in v, so the sub-lanes' c_t are, in exact
   arithmetic, the one chain's; in float32 they differ from it in the
   last bits;
4. the lanes' sums add up in float64, after log c of the first scored
   position.

:func:`sequence_loglik_stacked` scores the reduced members of a stacked
comparison group over their shared stream: step 1 is one launch of B21
(``fb_onehot.products_reduced_stacked``) and step 3 one launch of the
reduced chain for every member, each score equal to the member's own.

The JAX package's PAD rule is kept: a symbol >= S, or a position at or past
``length``, is an identity step (no transition, nothing scored), a PAD
first position included — the prior then carries unscored to the first
real symbol, which is scored through A.  An impossible observation (c = 0)
scores -inf, never nan.  The chains round every operation on its own
(XLA contracts the JAX scan's matmul into FMAs), so the score agrees with
the JAX package's within a tolerance (rtol 1e-5).

A model outside both chains' domains (not reduced-eligible, and K > 8 or
S > 16) is scored by the JAX function's serial chain in plain torch
(``forward_backward.sequence_loglik_serial``, :func:`scoring_engine`
"xla").

Each kernel wrapper takes its plain version for a CPU tensor, launches the
kernel for a CUDA tensor, and raises otherwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import _kernels, fb_onehot, fb_pallas
from cpgisland_tpu_torch.ops.fb_onehot import GROUP, _check_same_device
from cpgisland_tpu_torch.ops.fb_pallas import seq_sum
from cpgisland_tpu_torch.ops.viterbi_onehot import _check, _groups, pair_stream
from cpgisland_tpu_torch.utils import chunking

_I32 = torch.int32
_F32 = torch.float32
_F64 = torch.float64

# The scoring chains' sub-lanes (:func:`loglik_sublanes`): lanes of
# LOGLIK_SUBLANES_FROM steps or more run as sub-lanes of LOGLIK_SUBLANE_T
# steps (at most fb_onehot.MAX_SUBLANES), shorter lanes as one chain.
LOGLIK_SUBLANE_T = 256
LOGLIK_SUBLANES_FROM = 8192


def loglik_sublanes(Tp: int, K: int = GROUP) -> int:
    """G, the sub-lanes the scoring kernels cut a lane of Tp steps into: 1
    below :data:`LOGLIK_SUBLANES_FROM` steps or for a dense chain of K >
    ``fb_pallas.BWD_SUBLANE_MAX_K`` states (the reduced chain's K is its
    group, 2), else Tp // :data:`LOGLIK_SUBLANE_T`, at most
    ``fb_onehot.MAX_SUBLANES``; each runs ceil(Tp / G) steps.  A function of
    Tp and K alone, so the CPU and the card compute the same function.

    Why these numbers: chip_smoke's sweep (H100).  At the posterior's 8,192
    lanes of 8,192 steps, sub-lanes of 2 Ki / 1 Ki / 512 / 256 steps ran
    0.979 / 0.623 / 0.533 / 0.514 ms (reduced) and 0.936 / 0.614 / 0.556 /
    0.529 (dense, K = 2) against 2.557 and 2.622 in one chain; at compare's
    8 Mi record (1,024 such lanes, blocks of 4) 0.904 / 0.475 / 0.263 /
    0.171 and 0.847 / 0.444 / 0.239 / 0.149, and on a placed 16 Ki record
    (2 lanes) 0.879 / 0.470 / 0.266 / 0.165 and 0.843 / 0.436 / 0.235 /
    0.135.  So 256: G = 32 on every lane of 8 Ki steps or more, the
    fastest where the card is not full (compare's records) and within 4%
    of the fastest where it is."""
    if Tp < LOGLIK_SUBLANES_FROM or K > fb_pallas.BWD_SUBLANE_MAX_K:
        return 1
    return max(1, min(Tp // LOGLIK_SUBLANE_T, fb_onehot.MAX_SUBLANES))


def _lanes_per_block(NL: int, M: int, sms: int) -> int:
    """Lanes a block of the sub-lane kernels holds on a card of ``sms`` SMs:
    32 (a warp a sub-lane, each load one 128-byte row), halved while the
    blocks, ceil(NL / lanes) x M, would leave SMs idle, down to 1 (a warp
    then holds 32 sub-lanes of one lane).  A lane's sub-lanes share one
    block, so on compare's few lanes 32-lane blocks put a few mostly dead
    warps on a few SMs.  The layout only: no sum depends on it."""
    lb = 32
    while lb > 1 and -(-NL // lb) * M < sms:
        lb //= 2
    return lb


def _layout(Tp: int, NL: int, M: int, K: int, dev) -> dict:
    """The sub-lane arguments of a scoring launch: G, and the lanes a block
    where G > 1."""
    G = loglik_sublanes(Tp, K)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if G > 1 else 0
    return {"G": G, "LB": _lanes_per_block(NL, M, sms)}


def _sublane_steps(Tp: int, G: int, dev):
    """(L, rows [G, L] each sub-lane step's row of the stream, inb [G, L]
    whether that step lies in the lane) for G sub-lanes of L = ceil(Tp /
    G) steps."""
    L = -(-Tp // G)
    t = torch.arange(G, device=dev)[:, None] * L + torch.arange(L, device=dev)
    return L, torch.clamp_max(t, Tp - 1), t < Tp


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """[..., G, NL] float64 sub-lane sums -> [..., NL], added g = 0 .. G-1."""
    out = parts[..., 0, :]
    for g in range(1, parts.shape[-2]):
        out = out + parts[..., g, :]
    return out


def oh_loglik_plain(pair2: torch.Tensor, enter: torch.Tensor, tabs: torch.Tensor):
    """Plain version of the reduced scoring chain -> [M, NL] float64.

    pair2 [Tp, NL] int32 (p >= S*S: a PAD, skipped), enter [M, 2, NL] each
    member's normalized entering direction per lane on its entry group,
    tabs [M, S*S + 1, 4] each member's pair table (identity last).  Per
    real step: raw_c = v0 * T[0, c] + v1 * T[1, c], c = raw_0 + raw_1, ll
    += log(c) in float64, and v <- raw / c where c > 0.  The member axis
    rides along one step loop (per member the same operations).  In one
    sub-lane (:func:`loglik_sublanes`) the one chain; in G > 1,
    :func:`_oh_loglik_sublanes_plain`."""
    G = loglik_sublanes(pair2.shape[0])
    if G > 1:
        return _oh_loglik_sublanes_plain(pair2, enter, tabs, G)
    nreal = tabs.shape[1] - 1
    pc = torch.clamp_max(pair2, nreal).long()
    real = pair2 < nreal
    v0, v1 = enter[:, 0], enter[:, 1]
    ll = torch.zeros(v0.shape, dtype=_F64, device=pair2.device)
    for t in range(pair2.shape[0]):
        m = tabs[:, pc[t]]  # [M, NL, 4]
        r = real[t]
        raw0 = v0 * m[..., 0] + v1 * m[..., 2]
        raw1 = v0 * m[..., 1] + v1 * m[..., 3]
        c = raw0 + raw1
        ll = torch.where(r, ll + torch.log(c.to(_F64)), ll)
        upd = r & (c > 0)
        v0, v1 = torch.where(upd, raw0 / c, v0), torch.where(upd, raw1 / c, v1)
    return ll


def _oh_loglik_sublanes_plain(pair2: torch.Tensor, enter: torch.Tensor, tabs: torch.Tensor,
                              G: int) -> torch.Tensor:
    """The reduced scoring kernel's sub-lane function -> [M, NL] float64.

    Each lane's steps split into G sub-lanes [g L, min((g + 1) L, Tp)), L =
    ceil(Tp / G), carried side by side as a [G, NL] axis, in the kernel's
    three phases and its f32 operations in its order:
    1. each sub-lane's product of its step matrices (B7's phase 1,
       ``fb_onehot._sub_products_plain``), and whether it has a real step;
    2. the messages, from ``enter``, sub-lane by sub-lane up: v <- (v . P_g)
       times 1 / max(its sum, 1e-30) (B4's forward message) where sub-lane
       g has a real step, else v passes on; sub-lane g > 0 starts from v /
       max(v0 + v1, 1e-30), normalized once, sub-lane 0 from ``enter``;
    3. the chain of :func:`oh_loglik_plain` over every sub-lane from its
       message; each lane's G float64 sums added in order g = 0 .. G-1."""
    Tp, NL = pair2.shape
    nreal = tabs.shape[1] - 1
    L, rows, inb = _sublane_steps(Tp, G, pair2.device)
    real = (pair2[rows] < nreal) & inb[:, :, None]  # [G, L, NL]
    has = real.any(1)
    c00, c01, c10, c11 = fb_onehot._sub_products_plain(pair2, tabs, G)  # [M, G, NL]
    v0, v1 = enter[:, 0], enter[:, 1]
    s0, s1 = [v0], [v1]
    for g in range(G - 1):
        r0 = v0 * c00[:, g] + v1 * c10[:, g]
        r1 = v0 * c01[:, g] + v1 * c11[:, g]
        inv = torch.reciprocal(torch.clamp_min(r0 + r1, 1e-30))
        v0, v1 = torch.where(has[g], r0 * inv, v0), torch.where(has[g], r1 * inv, v1)
        d = torch.clamp_min(v0 + v1, 1e-30)
        s0.append(v0 / d)
        s1.append(v1 / d)
    v0, v1 = torch.stack(s0, 1), torch.stack(s1, 1)  # [M, G, NL]
    pc = torch.clamp_max(pair2, nreal).long()
    ll = torch.zeros(v0.shape, dtype=_F64, device=pair2.device)
    for k in range(L):
        m = tabs[:, pc[rows[:, k]]]  # [M, G, NL, 4]
        r = real[:, k]
        raw0 = v0 * m[..., 0] + v1 * m[..., 2]
        raw1 = v0 * m[..., 1] + v1 * m[..., 3]
        c = raw0 + raw1
        ll = torch.where(r, ll + torch.log(c.to(_F64)), ll)
        upd = r & (c > 0)
        v0, v1 = torch.where(upd, raw0 / c, v0), torch.where(upd, raw1 / c, v1)
    return _sum_in_order(ll)


def oh_loglik(pair2: torch.Tensor, enter: torch.Tensor, tabs: torch.Tensor):
    """The reduced scoring kernel (``csrc/loglik.cu`` ``oh_loglik_kernel``,
    ``oh_loglik_sub_kernel`` in :func:`loglik_sublanes` sub-lanes; no TPU
    counterpart) for M members over one pair stream -> [M, NL] float64, in
    one launch.  Arguments as :func:`oh_loglik_plain`."""
    _check_same_device(pair2, (enter, tabs))
    if pair2.dim() != 2 or 0 in pair2.shape:
        raise ValueError(f"pair2 must be a non-empty [Tp, NL], got {tuple(pair2.shape)}")
    Tp, NL = pair2.shape
    _check("pair2", pair2, _I32, (Tp, NL))
    M = fb_onehot._check_stacked_tables(tabs)
    _check("enter", enter, _F32, (M, GROUP, NL))
    if pair2.device.type == "cpu":
        return oh_loglik_plain(pair2, enter, tabs)
    out = torch.empty((M, NL), dtype=_F64, device=pair2.device)
    _kernels.launch("oh_loglik", pair2, enter, tabs, out, Tp=Tp, NL=NL,
                    nreal=tabs.shape[1] - 1, M=M, **_layout(Tp, NL, M, GROUP, pair2.device))
    return out


def fb_loglik_plain(sel2: torch.Tensor, enter: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """Plain version of the dense scoring chain -> [NL] float64.

    sel2 [Tp, NL] int32 symbols (>= S: a PAD, skipped), enter [K, NL] each
    lane's normalized entering direction, A [K, K], B [K, S].  Per real
    step: raw_j = (sum_k v_k A[k, j], in order of k) * B[j, o_t], c = sum_j
    raw_j in order, ll += log(c) in float64, v <- raw / c where c > 0.  In
    one sub-lane (:func:`loglik_sublanes`) the one chain; in G > 1,
    :func:`_fb_loglik_sublanes_plain`."""
    K, S = B.shape
    G = loglik_sublanes(sel2.shape[0], K)
    if G > 1:
        return _fb_loglik_sublanes_plain(sel2, enter, A, B, G)
    real = (sel2 < S).unbind(0)
    bo = B[:, torch.clamp_max(sel2, S - 1).long()].unbind(1)  # per-step [K, NL]
    v = enter
    ll = torch.zeros(sel2.shape[1], dtype=_F64, device=sel2.device)
    for b, r in zip(bo, real):
        acc = v[0][None, :] * A[0][:, None]
        for k in range(1, K):
            acc = acc + v[k][None, :] * A[k][:, None]
        raw = acc * b
        c = seq_sum(raw, 0)
        ll = torch.where(r, ll + torch.log(c.to(_F64)), ll)
        v = torch.where(r & (c > 0), raw / c, v)
    return ll


def _fb_loglik_sublanes_plain(sel2: torch.Tensor, enter: torch.Tensor, A: torch.Tensor,
                              B: torch.Tensor, G: int) -> torch.Tensor:
    """The dense scoring kernel's sub-lane function -> [NL] float64.

    Each lane's steps split into G sub-lanes [g L, min((g + 1) L, Tp)), L =
    ceil(Tp / G), carried side by side as a [G, NL] axis, in the kernel's
    three phases and its f32 operations in its order:
    1. each sub-lane's product P of its step matrices M_t[j, k] = A[j, k] *
       B[k, o_t] over its real steps, scaled every 8 steps by a power of two
       (B16's phase 1, ``fb_pallas._fwd_sub_products``), and whether it has
       a real step;
    2. the messages, from ``enter``, sub-lane by sub-lane up (B16's phase 2,
       ``fb_pallas._fwd_sub_messages``: v <- v . P_g times 2^-e where
       sub-lane g has a real step); sub-lane g > 0 starts from v / max(sum
       v, 1e-30), normalized once, sub-lane 0 from ``enter``;
    3. the chain of :func:`fb_loglik_plain` over every sub-lane from its
       message; each lane's G float64 sums added in order g = 0 .. G-1."""
    Tp, NL = sel2.shape
    K, S = B.shape
    L, rows, inb = _sublane_steps(Tp, G, sel2.device)
    real = (sel2[rows] < S) & inb[:, :, None]  # [G, L, NL]
    o = torch.clamp_max(sel2, S - 1).long()
    P = fb_pallas._fwd_sub_products(o, rows, real, inb, A, B)
    starts = fb_pallas._fwd_sub_messages(enter, P, real.any(1))
    v = torch.stack(starts[:1] + [x / torch.clamp_min(seq_sum(x, 0), 1e-30)
                                  for x in starts[1:]], 1)  # [K, G, NL]
    ll = torch.zeros((G, NL), dtype=_F64, device=sel2.device)
    for k in range(L):
        acc = v[0][None] * A[0][:, None, None]
        for j in range(1, K):
            acc = acc + v[j][None] * A[j][:, None, None]
        raw = acc * B[:, o[rows[:, k]]]
        c = seq_sum(raw, 0)
        r = real[:, k]
        ll = torch.where(r, ll + torch.log(c.to(_F64)), ll)
        v = torch.where(r & (c > 0), raw / c, v)
    return _sum_in_order(ll)


def fb_loglik(sel2: torch.Tensor, enter: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """The dense scoring kernel (``csrc/loglik.cu`` ``fb_loglik_kernel<K>``,
    ``fb_loglik_sub_kernel<K>`` in :func:`loglik_sublanes` sub-lanes; no TPU
    counterpart) -> [NL] float64, in one launch.  Arguments as
    :func:`fb_loglik_plain`."""
    _check_same_device(sel2, (enter, A, B))
    if sel2.dim() != 2 or 0 in sel2.shape:
        raise ValueError(f"sel2 must be a non-empty [Tp, NL], got {tuple(sel2.shape)}")
    Tp, NL = sel2.shape
    K, S = B.shape
    if not (1 <= K <= fb_pallas.MAX_STATES and 1 <= S <= fb_pallas.MAX_SYMBOLS):
        raise ValueError(f"dense scoring needs K <= {fb_pallas.MAX_STATES} and S <= "
                         f"{fb_pallas.MAX_SYMBOLS}, got {K} / {S}")
    _check("sel2", sel2, _I32, (Tp, NL))
    _check("enter", enter, _F32, (K, NL))
    _check("A", A, _F32, (K, K))
    _check("B", B, _F32, (K, S))
    if sel2.device.type == "cpu":
        return fb_loglik_plain(sel2, enter, A, B)
    out = torch.empty(NL, dtype=_F64, device=sel2.device)
    _kernels.launch("fb_loglik", sel2, enter, A, B, out, Tp=Tp, NL=NL, K=K, S=S,
                    **_layout(Tp, NL, 1, K, sel2.device))
    return out


def scoring_engine(params: HmmParams) -> str:
    """"onehot" (the reduced chain) for a reduced-eligible model within the
    pair tables' alphabet, "pallas" (the dense chain) for K <= 8, else
    "xla": the JAX package's serial chain in plain torch
    (``forward_backward.sequence_loglik_serial``)."""
    if (family_partition.reduced_eligible(params)
            and params.n_symbols <= fb_onehot.MAX_SYMBOLS):
        return "onehot"
    if fb_pallas.supports(params):
        return "pallas"
    return "xla"


def _vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """out[..., j] = sum_k v[..., k] * m[..., k, j], in order of k."""
    acc = v[..., 0:1] * m[..., 0, :]
    for k in range(1, m.shape[-2]):
        acc = acc + v[..., k : k + 1] * m[..., k, :]
    return acc


def _scoring_stream(obs, length: Optional[int], S: int, dev, lane_T: Optional[int]):
    """The record's steps after its first scored position, laid out in
    lanes: (f, o_f, sel2 [lane_T, NL] int32 with S marking every identity
    step), or None when nothing is scored.  Depends on the symbols and the
    alphabet only, so a stacked group shares it."""
    from cpgisland_tpu_torch.ops import fb_seq

    obs = chunking.upload(obs, dev)
    T = int(obs.shape[0])
    L = T if length is None else min(int(length), T)
    pos = torch.arange(T, device=dev)
    valid = (pos < L) & (obs.to(_I32) < S)
    idx = torch.nonzero(valid)
    if idx.numel() == 0:
        return None
    f = int(idx[0, 0])
    sel_flat = torch.where(valid & (pos > f), obs.to(_I32), S).to(_I32)
    lt = lane_T or fb_seq.pick_lane_T(T)
    NL = -(-T // lt)
    sel2 = torch.nn.functional.pad(sel_flat, (0, NL * lt - T), value=S).reshape(NL, lt).T
    return f, int(obs[f]), sel2.contiguous()


def _first_scored(params: HmmParams, f: int, o_f: int):
    """(c0, the normalized alpha there): pi * B[:, o] at position 0, else
    the prior carried through a PAD lead and one transition."""
    A, B, pi = (x.to(_F32) for x in (params.A, params.B, params.pi))
    a0 = (pi if f == 0 else _vecmat(pi, A)) * B[:, o_f]
    c0 = seq_sum(a0, 0)
    return float(c0), a0 / c0


def _total(c0: float, lanes: torch.Tensor) -> float:
    return -math.inf if c0 <= 0.0 else math.log(c0) + float(lanes.sum())


def _reduced_scores(params_list, stream, stacked: bool) -> list:
    """Scores of reduced members over one shared stream: lane products from
    B7 per member, or from ONE launch of B21 (``stacked``), then ONE launch
    of the scoring kernel for every member."""
    from cpgisland_tpu_torch.ops import fb_seq

    f, o_f, sel2 = stream
    S = params_list[0].n_symbols
    dev = sel2.device
    pair2, e_in, _ = pair_stream(S, sel2, o_f)
    if stacked:
        reds = fb_onehot.products_reduced_stacked(params_list, pair2)
    else:
        reds = [fb_onehot.products_reduced(p, pair2) for p in params_list]
    c0s, enters = [], []
    for params, red in zip(params_list, reds):
        c0, base = _first_scored(params, f, o_f)
        gt = _groups(params)
        excl = torch.cat([torch.eye(GROUP, dtype=_F32, device=dev)[None],
                          fb_seq._scan(red)[:-1]], dim=0)
        enters.append(fb_seq._norm_rows(_vecmat(base[gt[e_in[0].long()]], excl)).T)
        c0s.append(c0)
    lanes = oh_loglik(pair2, torch.stack(enters).contiguous(),
                      fb_onehot.stacked_tables(params_list)[1])
    # A row of its own per member (as fb_onehot.run_seq_stats_onehot_stacked
    # returns its counts): the float64 sum then adds in the single-model order.
    return [_total(c0, lanes[m].clone()) for m, c0 in enumerate(c0s)]


def sequence_loglik(params: HmmParams, obs, length: Optional[int] = None, *,
                    lane_T: Optional[int] = None) -> float:
    """log P(obs[:length] | params) as a Python float, on the params' device
    (see the module docstring for the PAD rule and the lanes).  ``obs``: a
    uint8 / int tensor or array of symbols; ``lane_T`` default: the
    posterior's (``fb_seq.pick_lane_T``)."""
    from cpgisland_tpu_torch.ops import fb_seq

    dev = params.device
    K, S = params.n_states, params.n_symbols
    eng = scoring_engine(params)
    if eng == "xla":
        from cpgisland_tpu_torch.ops.forward_backward import sequence_loglik_serial

        return float(sequence_loglik_serial(params, chunking.upload(obs, dev), length))
    stream = _scoring_stream(obs, length, S, dev, lane_T)
    if stream is None:
        return 0.0  # nothing scored: the prior carries through
    if eng == "onehot":
        return _reduced_scores([params], stream, stacked=False)[0]
    f, o_f, sel2 = stream
    c0, base = _first_scored(params, f, o_f)
    if c0 <= 0.0:
        return -math.inf
    A, B = params.A.to(_F32).contiguous(), params.B.to(_F32).contiguous()
    P = fb_pallas._run_products_kernel(A, B, sel2)
    excl = torch.cat([torch.eye(K, dtype=_F32, device=dev)[None],
                      fb_seq._scan(P)[:-1]], dim=0)
    enter = fb_seq._norm_rows(_vecmat(base, excl))
    return _total(c0, fb_loglik(sel2, enter.T.contiguous(), A, B))


def sequence_loglik_stacked(params_list, obs, length: Optional[int] = None, *,
                            lane_T: Optional[int] = None) -> list:
    """:func:`sequence_loglik` of M reduced members of one alphabet over one
    record, in one launch of B21 (their lane products) and one of the
    scoring kernel: the scoring half of a stacked comparison group.  Each
    score equals the member's own :func:`sequence_loglik` bit for bit."""
    S = fb_onehot.check_stacked_members(params_list)
    for p in params_list:
        if scoring_engine(p) != "onehot":
            raise ValueError("stacked scoring takes reduced-eligible members only")
    stream = _scoring_stream(obs, length, S, params_list[0].device, lane_T)
    if stream is None:
        return [0.0] * len(params_list)
    return _reduced_scores(list(params_list), stream, stacked=True)
