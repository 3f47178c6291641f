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
   (dense, symbol stream), kernels of ``csrc/loglik.cu``;
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

_I32 = torch.int32
_F32 = torch.float32
_F64 = torch.float64


def oh_loglik_plain(pair2: torch.Tensor, enter: torch.Tensor, tabs: torch.Tensor):
    """Plain version of the reduced scoring chain -> [M, NL] float64.

    pair2 [Tp, NL] int32 (p >= S*S: a PAD, skipped), enter [M, 2, NL] each
    member's normalized entering direction per lane on its entry group,
    tabs [M, S*S + 1, 4] each member's pair table (identity last).  Per
    real step: raw_c = v0 * T[0, c] + v1 * T[1, c], c = raw_0 + raw_1, ll
    += log(c) in float64, and v <- raw / c where c > 0.  The member axis
    rides along one step loop (per member the same operations)."""
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


def oh_loglik(pair2: torch.Tensor, enter: torch.Tensor, tabs: torch.Tensor):
    """The reduced scoring kernel (``csrc/loglik.cu`` ``oh_loglik_kernel``;
    no TPU counterpart) for M members over one pair stream -> [M, NL]
    float64.  Arguments as :func:`oh_loglik_plain`."""
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
                    nreal=tabs.shape[1] - 1, M=M)
    return out


def fb_loglik_plain(sel2: torch.Tensor, enter: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """Plain version of the dense scoring chain -> [NL] float64.

    sel2 [Tp, NL] int32 symbols (>= S: a PAD, skipped), enter [K, NL] each
    lane's normalized entering direction, A [K, K], B [K, S].  Per real
    step: raw_j = (sum_k v_k A[k, j], in order of k) * B[j, o_t], c = sum_j
    raw_j in order, ll += log(c) in float64, v <- raw / c where c > 0."""
    K, S = B.shape
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


def fb_loglik(sel2: torch.Tensor, enter: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """The dense scoring kernel (``csrc/loglik.cu`` ``fb_loglik_kernel<K>``;
    no TPU counterpart) -> [NL] float64.  Arguments as
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
    _kernels.launch("fb_loglik", sel2, enter, A, B, out, Tp=Tp, NL=NL, K=K, S=S)
    return out


def scoring_engine(params: HmmParams) -> str:
    """"onehot" (the reduced chain) for a reduced-eligible model within the
    pair tables' alphabet, "pallas" (the dense chain) for K <= 8, else
    NotImplementedError (the generic engines, ROADMAP A2)."""
    if (family_partition.reduced_eligible(params)
            and params.n_symbols <= fb_onehot.MAX_SYMBOLS):
        return "onehot"
    if fb_pallas.supports(params):
        return "pallas"
    raise NotImplementedError(
        f"scoring a model of {params.n_states} states over {params.n_symbols} symbols needs "
        "the generic engines, not ported yet (ROADMAP A2)"
    )


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

    obs = torch.as_tensor(obs).to(dev)
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
