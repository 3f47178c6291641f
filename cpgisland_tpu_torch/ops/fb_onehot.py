"""One-hot-emission reduced forward-backward: two CUDA kernels and their
plain PyTorch versions.

Counterpart of ``cpgisland_tpu/ops/fb_onehot.py``, cut to the fused
chunked E-step.  For one-hot-emission models (the flagship 8-state
preset) the alpha/beta vectors are exactly zero outside the 2-state group
of the position's symbol, so the K-state recurrences reduce to 2-state
recurrences whose per-step 2x2 matrix is A (times the emission
probability) between the previous symbol's group and the current one's —
the per-pair table :func:`prob_pair_table`.

- B4 :func:`oh_fwdbwd` (replaces ``_oh_fwdbwd_kernel``): the forward
  chain with deferred Rabiner scaling and the self-normalized backward
  chain, independent of each other, in one launch.  The plain version
  :func:`oh_fwdbwd_plain` is the twin of ``_xla_fwdbwd_onehot``: the same
  f32 operations in the same order, the row select an exact gather.  The
  kernel turns FMA contraction off, so it equals the plain version bit for
  bit.
- B5 :func:`oh_seq_stats` (replaces ``_oh_seq_stats_kernel``): the
  z-normalized counts — each pair's xi divided by its own total, so any
  per-position scale of the betas cancels — giving dense ``macc [K*K]``,
  reduced ``emit [2S]`` and the loglik per lane.  The plain version
  :func:`oh_seq_stats_plain` is the twin of ``_xla_znorm_stats``; the two
  sum over time in different orders and agree within a tolerance.

Each wrapper takes the plain version for a CPU tensor, launches its kernel
(``csrc/fb_onehot.cu``) for a CUDA tensor, and raises otherwise.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops.viterbi_onehot import GROUP, _check, _groups, pair_stream

_I32 = torch.int32
_F32 = torch.float32

PROB_IDENT = (1.0, 0.0, 0.0, 1.0)  # the (+, x) identity matrix entries
# Largest alphabet the kernels take: their pair tables live in shared memory.
MAX_SYMBOLS = 16


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
    ident = torch.tensor([PROB_IDENT], dtype=_F32, device=gt.device)
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
# B4: the co-scheduled forward and self-normalized backward chains


def oh_fwdbwd_plain(pair2: torch.Tensor, pairn2: torch.Tensor, lens2: torch.Tensor,
                    a0_red: torch.Tensor, beta0_red: torch.Tensor, tab_ext: torch.Tensor,
                    T: int):
    """Plain version of B4 -> (alphas2 [Tp, 2, NL], betas2 [Tp, 2, NL]).

    pair2 / pairn2 [Tp, NL] int32 (pairn2[t] = pair2[t + 1]), lens2 [1, NL],
    a0_red / beta0_red [2, NL] the entering vectors, tab_ext [S*S + 1, 4]
    (identity last), T the chunk length.  Forward: alpha_t =
    (alpha_{t-1} . M_t) / sum(alpha_{t-1}) on valid steps, the entering
    vector at t == 0, carried past the lane's length.  Backward: beta_t =
    (M_{t+1} . beta_{t+1}) / sum(beta_{t+1}) for t <= min(T, len) - 2,
    carried elsewhere.  Both components of each chain are computed
    elementwise in one [2, NL] tensor; per element the operations and
    their order are the twin's."""
    Tp, NL = pair2.shape
    nreal = tab_ext.shape[0] - 1
    steps = torch.arange(Tp, device=pair2.device)[:, None]
    valid = (steps < lens2).unbind(0)  # per-step [NL] views
    keep = ((steps <= T - 2) & (steps + 1 < lens2)).unbind(0)

    def matrices(pairs, order):
        # Each step's 2x2 matrix as [2 (summed index), 2 (output), NL]; a
        # sum over 2 terms is one rounded addition, x0 + x1, in any order.
        m = tab_ext[torch.clamp_max(pairs, nreal).long()][..., order]  # [Tp, NL, 4]
        return m.reshape(Tp, NL, 2, 2).permute(0, 2, 3, 1).contiguous().unbind(0)

    # raw_c = v0 * T[0, c] + v1 * T[1, c], times 1 / (v0 + v1).
    fwd = matrices(pair2, [0, 1, 2, 3])  # [a, c] = T[a, c]
    alphas = [a0_red]
    for t in range(1, Tp):
        v = alphas[-1]
        inv = torch.reciprocal(v.sum(0))
        raw = (v[:, None, :] * fwd[t]).sum(0)
        alphas.append(torch.where(valid[t], raw * inv, v))

    # b_a = G[a, 0] * bn0 + G[a, 1] * bn1: the raw contraction first, then
    # the previous beta's own reciprocal sum — the kernel's order.
    bwd = matrices(pairn2, [0, 2, 1, 3])  # [c, a] = G[a, c]
    betas = [beta0_red]
    for tb in range(Tp - 1, -1, -1):
        bn = betas[-1]
        binv = torch.reciprocal(bn.sum(0))
        b = (bn[:, None, :] * bwd[tb]).sum(0) * binv
        betas.append(torch.where(keep[tb], b, bn))
    return torch.stack(alphas), torch.stack(betas[:0:-1])


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
    (alphas2, betas2), each [Tp, 2, NL] f32.  Arguments as
    :func:`oh_fwdbwd_plain`."""
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
    if pair2.device.type == "cpu":
        return oh_fwdbwd_plain(pair2, pairn2, lens2, a0_red, beta0_red, tab_ext, T)
    alphas = torch.empty((Tp, GROUP, NL), dtype=_F32, device=pair2.device)
    betas = torch.empty((Tp, GROUP, NL), dtype=_F32, device=pair2.device)
    _kernels.launch("oh_fwdbwd", pair2, pairn2, lens2, a0_red, beta0_red, tab_ext,
                    alphas, betas, Tp=Tp, NL=NL, nreal=tab_ext.shape[0] - 1, T=T)
    return alphas, betas


# ---------------------------------------------------------------------------
# B5: z-normalized counts from the reduced streams


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
    if alphas2.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("oh_seq_stats_plain needs full f32 matmuls (allow_tf32 is set)")
    T4 = tab_ext[torch.clamp_max(pair2, S * S).long()]  # [Tp, NL, 4]
    esym2 = decode_esym(pair2, S)
    el = esym2.long()
    a0, a1 = alphas2[:, 0], alphas2[:, 1]
    be0, be1 = betas2[:, 0], betas2[:, 1]
    cs = a0 + a1
    inv_cs = torch.reciprocal(torch.clamp_min(cs, 1e-30))
    vmask = torch.arange(Tp, device=pair2.device)[:, None] < lens2
    g0, g1 = a0 * be0, a1 * be1
    inv_g = torch.reciprocal(torch.clamp_min(g0 + g1, 1e-30))
    gm0 = torch.where(vmask, g0 * inv_g, 0.0)
    gm1 = torch.where(vmask, g1 * inv_g, 0.0)
    emit_rows = []
    for s in range(S):
        m = esym2 == s
        emit_rows.append(torch.sum(torch.where(m, gm0, 0.0), dim=0))
        emit_rows.append(torch.sum(torch.where(m, gm1, 0.0), dim=0))
    emit_red = torch.stack(emit_rows, dim=0)  # [2S, NL]
    ll = torch.sum(torch.where(vmask, torch.log(torch.clamp_min(cs, 1e-30)), 0.0),
                   dim=0)[None, :]
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


def oh_seq_stats(alphas2, betas2, pair2, lens2, tab_ext, B_red, gt, enters_full,
                 enters_red, pair0m, Tt: int):
    """Kernel B5 (replaces ``_oh_seq_stats_kernel``) -> (macc, emit_red, ll).
    Arguments as :func:`oh_seq_stats_plain`; the kernel reduces each lane
    in segments of ``Tt`` steps, then sums the segments in order (no
    atomics: the result does not change from run to run)."""
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
    if Tt <= 0:
        raise ValueError(f"Tt must be positive, got {Tt}")
    if pair2.device.type == "cpu":
        return oh_seq_stats_plain(alphas2, betas2, pair2, lens2, tab_ext, B_red, gt,
                                  enters_full, enters_red, pair0m)
    dev = pair2.device
    rows = 4 * S * S + 2 * S + 1  # per-lane accumulators: pair bins, emit, ll
    part = torch.empty((-(-Tp // Tt), rows, NL), dtype=_F32, device=dev)
    macc = torch.empty((K * K, NL), dtype=_F32, device=dev)
    emit_red = torch.empty((2 * S, NL), dtype=_F32, device=dev)
    ll = torch.empty((1, NL), dtype=_F32, device=dev)
    _kernels.launch("oh_seq_stats", alphas2, betas2, pair2, lens2, tab_ext, B_red, gt,
                    enters_full, enters_red, pair0m, part, macc, emit_red, ll,
                    Tp=Tp, NL=NL, S=S, K=K, Tt=Tt)
    return macc, emit_red, ll


# ---------------------------------------------------------------------------
# Runners (the JAX module's entry points)


def run_fb_kernels_onehot(params: HmmParams, sel_t, prev_dev, lens2: torch.Tensor,
                          a0_raw: torch.Tensor, beta0: torch.Tensor, T: int, *,
                          pair_esym=None, fused: bool = True, conf_mask=None):
    """Reduced forward + backward over the [Tp, NL] lane layout.

    a0_raw / beta0 arrive full-K [K, NL] and are projected onto each lane's
    entry / exit group here.  ``pair_esym``: a prepared (pair2, esym2,
    pairn2) stream; otherwise it is built from ``sel_t`` and ``prev_dev``.
    Returns (alphas2 [Tp, 2, NL], betas2 [Tp, 2, NL] self-normalized, esym2
    [Tp, NL]).  Unlike the JAX runner it returns no Rabiner scales: the
    z-normalized stats, the only consumer here, do not read them."""
    if not fused:
        raise NotImplementedError(
            "the split forward/backward arm (kernels B9/B10 with the cs-scaled "
            "stats B12) is not ported yet (ROADMAP §B)"
        )
    if conf_mask is not None:
        raise NotImplementedError(
            "in-pass island confidence (posterior, kernel B11) is not ported yet "
            "(ROADMAP A7)"
        )
    from cpgisland_tpu_torch.ops.prepared import _pair_next

    S = params.n_symbols
    gt = _groups(params)
    if pair_esym is None:
        pair2, _, _ = pair_stream(S, sel_t, prev_dev)
        esym2, pairn2 = decode_esym(pair2, S), _pair_next(pair2, S)
    else:
        pair2, esym2, pairn2 = pair_esym
    a0_red = torch.gather(a0_raw.T, 1, gt[esym2[0].long()]).T.contiguous()
    beta0_red = torch.gather(beta0.T, 1, gt[esym2[-1].long()]).T.contiguous()
    alphas2, betas2 = oh_fwdbwd(pair2, pairn2, lens2, a0_red.to(_F32),
                                beta0_red.to(_F32), prob_tab_ext(params, gt), T)
    return alphas2, betas2, esym2


def run_seq_stats_onehot(params: HmmParams, alphas2, betas2, pair2, lens2, gt,
                         enters_red, enters_full, pair0_mask, Tt: int):
    """Z-normalized stats from the reduced streams (power-of-two S).
    Returns (macc [K*K, NL] — trans = A * macc summed over lanes; emit_red
    [2S, NL]; ll [1, NL]).  The chunked caller passes zero enters and an
    all-zero pair0 mask: every lane is a record with no incoming pair."""
    S = params.n_symbols
    if S & (S - 1):
        raise ValueError("run_seq_stats_onehot: power-of-two S only")
    B = params.B.to(_F32)
    B_red = B[gt, torch.arange(S, device=gt.device)[:, None]].contiguous()
    return oh_seq_stats(alphas2, betas2, pair2, lens2, prob_tab_ext(params, gt), B_red,
                        gt.to(_I32).contiguous(), enters_full, enters_red, pair0_mask, Tt)
