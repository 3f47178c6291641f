"""Dense forward-backward engine ("pallas"): five CUDA kernels and their
plain PyTorch versions.

Counterpart of the dense half of ``cpgisland_tpu/ops/fb_pallas.py``: the
rescaled E-step and posterior streams for any model with K <= 8 states,
whatever its emissions (``--preset two_state``, a ``--model`` file whose
emissions are not one-hot pairs, or the flagship's own tables when
``engine="pallas"`` is asked for).  The kernels (``csrc/fb_dense.cu``) run
one thread per lane over the time-major streams, with A and B in shared
memory and the K-state vectors in registers:

- B16 :func:`fb_fwd` (replaces ``_fwd_kernel``): the forward with deferred
  Rabiner scaling, v_t = ((sum_j v_{t-1}[j] A[j, k]) * B[k, o_t]) *
  (1 / sum v_{t-1}), so the stored alphas carry alpha-hat_t * c_t and the
  scale factors come back as row sums; at K <= 4 each lane runs as
  :func:`fwd_sublanes` sub-lanes joined by exact boundary messages (the
  step is degree 0 in v_{t-1}, so a message's direction is all a sub-lane
  needs: :func:`_fwd_sublanes_plain`);
- B17 :func:`fb_prod` (replaces ``_prod_kernel``): each lane's (+, x)
  product of its step matrices A[m, j] * B[j, o_t] (the identity for PAD),
  renormalized after every 8th step — the lane transfer operators of the
  whole-sequence boundary messages;
- B18 :func:`fb_bwd` (replaces ``_bwd_kernel``): the backward on the
  time-shifted o_{t+1}, c_{t+1}; at K <= 4 each lane runs as
  :func:`bwd_sublanes` sub-lanes joined by exact boundary messages that
  carry the betas' true magnitude (power-of-two scaled transfer matrices,
  :func:`_bwd_sublanes_plain`);
- B19 :func:`fb_bwd_conf` (replaces ``_bwd_conf_kernel``): B18's chain
  emitting the island confidence instead of storing betas;
- B20 :func:`fb_stats` (replaces ``_stats_kernel``): per-lane expected
  counts and loglik from the stored streams.

Each wrapper takes its plain version for a CPU tensor, launches the kernel
for a CUDA tensor, and raises otherwise.  The plain versions of B16-B19 do
the kernels' float32 operations in the kernels' order — every K-term sum
sequential from j = 0, every reciprocal an IEEE division — so kernel and
plain version agree bit for bit (B16 and B18 in one sub-lane are the
sequential chains; in G > 1 they differ from them in the last bits); B20 sums
over time in another order and agrees within a tolerance.  Against the
JAX package (XLA:CPU contracts products into FMAs and reduces in its own
order) they agree within the parity tests' tolerances.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import _kernels, fb_onehot
from cpgisland_tpu_torch.ops.viterbi_pallas import _check

MAX_STATES = 8  # the kernels' register-resident state vectors
MAX_SYMBOLS = 16  # the kernels' shared-memory emission tables
ROW_TILE = 8  # B17 renormalizes its product after every ROW_TILE steps
# B16 and B18 run in sub-lanes up to this K (the csrc SUB_MAX_K): a
# sub-lane's K x K transfer matrix a thread costs K^3 operations a step,
# which at K = 8 is the instruction stream B17's first design drowned in.
BWD_SUBLANE_MAX_K = 4
# B16's sub-lanes (:func:`fwd_sublanes`): lanes of FWD_SUBLANES_FROM steps or
# more run as sub-lanes of FWD_SUBLANE_T steps (at most
# fb_onehot.MAX_SUBLANES), shorter lanes as one chain.
FWD_SUBLANE_T = 512
FWD_SUBLANES_FROM = 8192
# B18's sub-lanes (:func:`bwd_sublanes`): lanes of BWD_SUBLANES_FROM steps or
# more run as sub-lanes of BWD_SUBLANE_T steps (at most
# fb_onehot.MAX_SUBLANES), shorter lanes as one chain.
BWD_SUBLANE_T = 1024
BWD_SUBLANES_FROM = 8192

_I32 = torch.int32
_F32 = torch.float32


def supports(params: HmmParams) -> bool:
    """Kernel eligibility: K <= 8 states (the JAX package's envelope) over
    at most 16 symbols."""
    return params.n_states <= MAX_STATES and params.n_symbols <= MAX_SYMBOLS


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x summed along ``dim`` one term at a time, index 0 first: the
    kernels' order, and the same bits on the CPU and on the card."""
    parts = x.unbind(dim)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def emit_sel(B: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """B[:, syms] -> [K, *syms.shape]: the JAX package's ``_emit_sel``
    compare-select tree as one table lookup (the same f32 values)."""
    return B[:, syms.long()]


def step_table(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """B17's per-symbol step matrices [S + 1, K*K]: row s < S holds
    M_s[m, j] = A[m, j] * B[j, s] at m*K + j, row S the identity (PAD)."""
    K, S = B.shape
    M = A[None, :, :] * B.T[:, None, :]  # [s, m, j]
    eye = torch.eye(K, dtype=_F32, device=A.device)[None]
    return torch.cat([M, eye], dim=0).reshape(S + 1, K * K).contiguous()


# ---------------------------------------------------------------------------
# Plain versions.  Shapes are the kernels' own: steps2 / steps_next / sel2
# [Tp, NL] int32, lens2 [1, NL] int32, a0 / beta0 [K, NL], A [K, K],
# B [K, S], streams [Tp, K, NL], cs_next / conf [Tp, NL].


def fb_fwd_plain(steps2, lens2, a0, A, B) -> torch.Tensor:
    """Plain version of B16 -> alphas [Tp, K, NL]: v_0 = a0; for t >= 1,
    v_t = ((sum_j v_{t-1}[j] * A[j, k]) * B[k, o_t]) * (1 / sum v_{t-1})
    where t < len, v_{t-1} carried elsewhere.  In one sub-lane
    (:func:`fwd_sublanes`) the sequential chain; in G > 1,
    :func:`_fwd_sublanes_plain`."""
    G = fwd_sublanes(steps2.shape[0], B.shape[0])
    if G > 1:
        return _fwd_sublanes_plain(steps2, lens2, a0, A, B, G)
    return _fwd_chain_plain(steps2, lens2, a0, A, B)


def _fwd_chain_plain(steps2, lens2, a0, A, B) -> torch.Tensor:
    """The sequential forward chain of :func:`fb_fwd_plain` (B16 in one
    sub-lane)."""
    Tp, NL = steps2.shape
    K, S = B.shape
    out = torch.empty((Tp, K, NL), dtype=_F32, device=steps2.device)
    o = torch.clamp(steps2, 0, S - 1).long()
    valid = torch.arange(Tp, device=steps2.device)[:, None] < lens2
    v = a0
    out[0] = v
    for t in range(1, Tp):
        inv = torch.reciprocal(seq_sum(v, 0))
        raw = seq_sum(v[:, None, :] * A[:, :, None], 0)  # [k, NL]
        v = torch.where(valid[t], (raw * B[:, o[t]]) * inv, v)
        out[t] = v
    return out


def fwd_sublanes(Tp: int, K: int) -> int:
    """G, the sub-lanes B16 cuts a lane of Tp steps into: 1 at K >
    :data:`BWD_SUBLANE_MAX_K` or below :data:`FWD_SUBLANES_FROM` steps, else
    Tp // :data:`FWD_SUBLANE_T`, at most ``fb_onehot.MAX_SUBLANES``; each
    runs ceil(Tp / G) steps.  A function of Tp and K alone, so the CPU and
    the card compute the same function.

    Why these numbers: chip_smoke's sweeps at K = 2 (H100, two runs).  At
    the training batch's 1,024 lanes of 65,536 steps, sub-lanes of 4 Ki
    steps (G = 16) ran 1.236-1.253 ms, and 2 Ki down to 256 steps all stop
    at G = 32 (1.034-1.059 ms), against 6.62 in one chain.  At the
    posterior's 8,192 lanes of 8,192 steps, 4 Ki / 2 Ki / 1 Ki / 512 / 256
    ran 0.903 / 0.643 / 0.562 / 0.505 / 0.504 ms in one run and 0.849 /
    0.613 / 0.499 / 0.525 / 0.508 in the other (one chain 0.877-0.957):
    1 Ki down to 256 within the runs' spread.  So 512: G = 32 on the
    training batch, 16 on the posterior and ``seq`` lanes.  Lanes below 8
    Ki steps (the CPU tests' 4-4.5 Ki) stay one chain: no sweep covers
    them."""
    if K > BWD_SUBLANE_MAX_K or Tp < FWD_SUBLANES_FROM:
        return 1
    return max(1, min(Tp // FWD_SUBLANE_T, fb_onehot.MAX_SUBLANES))


def _fwd_sublanes_plain(steps2, lens2, a0, A, B, G: int) -> torch.Tensor:
    """B16's sub-lane function -> alphas [Tp, K, NL].

    Each lane's steps split into G sub-lanes [g L, min((g + 1) L, Tp)), L =
    ceil(Tp / G), carried side by side as a [G, NL] axis, in the kernel's
    three phases and its f32 operations in its order:
    1. each sub-lane's product P of its step matrices M_t[j, k] = A[j, k] *
       B[k, o_t] over its valid steps 1 <= t < len, from the identity, the
       chain's contraction applied to every row, t walking up; after every
       8th step counted from the sub-lane's start, P times 2^-e with e the
       binary exponent of its total (row-major, in order);
    2. the messages, from a0, sub-lane by sub-lane up: sub-lane g enters
       with v, then v <- v . P_g (each column's terms in order) times 2^-e
       (e of its sum); a sub-lane without a valid step passes v on
       unchanged;
    3. the chain of :func:`fb_fwd_plain` over every sub-lane from its
       message (sub-lane 0 from a0, so it stores a0 at t = 0); past the
       last valid step max(len, 1) - 1 every alpha is that step's.
    The step is degree 0 in v_{t-1} (its sum divides it out), so a message
    needs only the direction of the alpha before its sub-lane, and a
    power-of-two scale changes no bit of what the chain computes from it:
    in exact arithmetic the stored alphas are the sequential chain's."""
    Tp, NL = steps2.shape
    K, S = B.shape
    L = -(-Tp // G)
    dev = steps2.device
    t = torch.arange(G, device=dev)[:, None] * L + torch.arange(L, device=dev)  # [G, L]
    real = t < Tp
    rows = torch.clamp_max(t, Tp - 1)
    lens = lens2[0]
    ok = (t[:, :, None] >= 1) & (t[:, :, None] < lens) & real[:, :, None]  # [G, L, NL]
    o = torch.clamp(steps2, 0, S - 1).long()
    A5 = A[None, :, :, None, None]

    def emis(k):  # B[:, o_t] at step k of every sub-lane: [K, G, NL]
        return B[:, o[rows[:, k]]]

    # Phase 1: P [K (row i), K (column k), G, NL].
    P = torch.eye(K, dtype=_F32, device=dev)[:, :, None, None].expand(K, K, G, NL)
    for k in range(L):
        nP = seq_sum(P[:, :, None] * A5, 1) * emis(k)[None]
        P = torch.where(ok[:, k], nP, P)
        if k % 8 == 7:
            e = _scale_exp(seq_sum(P.reshape(K * K, G, NL), 0))
            P = torch.where(real[:, k][:, None], P * _pow2(-e), P)

    # Phase 2: each sub-lane's entering direction.
    has = ok.any(1)
    v = a0
    starts = []
    for g in range(G):
        starts.append(v)
        r = seq_sum(v[:, None] * P[:, :, g], 0)
        e = _scale_exp(seq_sum(r, 0))
        v = torch.where(has[g], r * _pow2(-e), v)

    # Phase 3: the chains, t = g L up to (g + 1) L - 1.
    v = torch.stack(starts, 1)  # [K, G, NL]
    out = []
    for k in range(L):
        inv = torch.reciprocal(seq_sum(v, 0))
        raw = seq_sum(v[:, None] * A[:, :, None, None], 0)  # [k, G, NL]
        v = torch.where(ok[:, k], (raw * emis(k)) * inv, v)
        out.append(v)
    al = torch.stack(out, 0).permute(2, 0, 1, 3).reshape(G * L, K, NL)[:Tp]
    last = torch.clamp_min(torch.clamp_max(lens, Tp), 1) - 1
    src = torch.minimum(torch.arange(Tp, device=dev)[:, None], last)  # [Tp, NL]
    return torch.gather(al, 0, src[:, None, :].expand(Tp, K, NL).long()).contiguous()


def bwd_sublanes(Tp: int, K: int) -> int:
    """G, the sub-lanes B18 cuts a lane of Tp steps into: 1 at K >
    :data:`BWD_SUBLANE_MAX_K` or below :data:`BWD_SUBLANES_FROM` steps, else
    Tp // :data:`BWD_SUBLANE_T`, at most ``fb_onehot.MAX_SUBLANES``; each
    runs ceil(Tp / G) steps.  A function of Tp and K alone, so the CPU and
    the card compute the same function.

    Why these numbers: chip_smoke's sweeps at K = 2 (H100).  At the
    training batch's 1,024 lanes of 65,536 steps, sub-lanes of 8 Ki / 4 Ki
    / 2 Ki steps ran 2.833 / 1.470 / 0.937 ms against 8.972 in one chain,
    and shorter ones stop at G = 32.  At the posterior's 8,192 lanes of
    8,192 steps, 4 Ki (G = 2) cost, 1.441 against 1.173 in one chain,
    while 2 Ki / 1 Ki / 512 / 256 ran 0.905 / 0.704 / 0.701 / 0.683 ms.
    So 1 Ki: G = 32 on the training batch, 8 on the posterior and ``seq``
    lanes, within 3% of the fastest at both; B4's 4 Ki
    (``fb_onehot.SUBLANE_T``) would cost on the 8 Ki-step lanes.  Lanes
    below 8 Ki steps (the CPU tests' 4-4.5 Ki) stay one chain: no sweep
    covers them."""
    if K > BWD_SUBLANE_MAX_K or Tp < BWD_SUBLANES_FROM:
        return 1
    return max(1, min(Tp // BWD_SUBLANE_T, fb_onehot.MAX_SUBLANES))


def fb_bwd_plain(steps_next, lens2, cs_next, beta0, A, B, T: int) -> torch.Tensor:
    """Plain version of B18 -> betas [Tp, K, NL]: from beta0 at t = Tp-1
    down to 0, beta_t[j] = sum_k A[j, k] * ((B[k, o_{t+1}] * (1 /
    c_{t+1})) * beta_{t+1}[k]) where t <= T-2 and t+1 < len, carried
    elsewhere (steps_next[t] = o_{t+1}, cs_next[t] = c_{t+1}).  In one
    sub-lane (:func:`bwd_sublanes`) the sequential chain; in G > 1,
    :func:`_bwd_sublanes_plain`."""
    G = bwd_sublanes(steps_next.shape[0], B.shape[0])
    if G > 1:
        return _bwd_sublanes_plain(steps_next, lens2, cs_next, beta0, A, B, T, G)
    return _bwd_chain_plain(steps_next, lens2, cs_next, beta0, A, B, T)


def _bwd_chain_plain(steps_next, lens2, cs_next, beta0, A, B, T: int) -> torch.Tensor:
    """The sequential backward chain of :func:`fb_bwd_plain` (B18 in one
    sub-lane, and B19's betas)."""
    Tp, NL = steps_next.shape
    K, S = B.shape
    out = torch.empty((Tp, K, NL), dtype=_F32, device=steps_next.device)
    o = torch.clamp(steps_next, 0, S - 1).long()
    invc = torch.reciprocal(cs_next)
    t_col = torch.arange(Tp, device=steps_next.device)[:, None]
    keep = (t_col <= T - 2) & (t_col + 1 < lens2)
    beta = beta0
    for t in range(Tp - 1, -1, -1):
        w = (B[:, o[t]] * invc[t]) * beta  # [k, NL]
        beta = torch.where(keep[t], seq_sum(A[:, :, None] * w[None, :, :], 1), beta)
        out[t] = beta
    return out


def _scale_exp(x: torch.Tensor) -> torch.Tensor:
    """x's binary exponent as int32 (frexp's for a normal x; -126 for 0 and
    subnormals), clamped to [-126, 126]: the kernel's scale_exp, read off
    the float's bits."""
    return torch.clamp(((x.view(torch.int32) >> 23) & 0xFF) - 126, -126, 126)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for int32 -126 <= e <= 126 (a normal float, built
    from its bits as the kernel's pow2f)."""
    return ((e + 127) << 23).view(_F32)


def _bwd_sublanes_plain(steps_next, lens2, cs_next, beta0, A, B, T: int,
                        G: int) -> torch.Tensor:
    """B18's sub-lane function -> betas [Tp, K, NL].

    Each lane's steps split into G sub-lanes [g L, min((g + 1) L, Tp)), L =
    ceil(Tp / G), carried side by side as a [G, NL] axis, in the kernel's
    three phases and its f32 operations in its order:
    1. each sub-lane's transfer matrix Q (beta at its start = Q . beta at
       its end) over its valid steps t < min(T - 1, len - 1), from the
       identity, the chain's step applied to every column, t walking down;
       after every 8th step counted from the sub-lane's padded end, Q times
       2^-e with e the binary exponent of its total (row-major, in order),
       e summed into an int E;
    2. the messages, from beta0 at the lane's end, sub-lane by sub-lane
       down: v <- Q . v (each row's terms in order), then v times 2^-e (e
       of its sum) and the exponents summed; a sub-lane without a valid
       step passes v on unchanged; a sub-lane's chain starts from (v
       2^E1) 2^E2, E = E1 + E2, E1 = E / 2 truncated;
    3. the chain of :func:`fb_bwd_plain` over every sub-lane from its
       message.
    Products by powers of two are exact, so the messages are, in exact
    arithmetic, the sequential chain's betas with their Rabiner scale."""
    Tp, NL = steps_next.shape
    K, S = B.shape
    L = -(-Tp // G)
    dev = steps_next.device
    t = torch.arange(G, device=dev)[:, None] * L + torch.arange(L, device=dev)  # [G, L]
    real = t < Tp
    rows = torch.clamp_max(t, Tp - 1)
    hi = torch.clamp_max(lens2[0] - 1, T - 1)
    ok = (t[:, :, None] < hi) & real[:, :, None]  # [G, L, NL]: the valid steps
    o = torch.clamp(steps_next, 0, S - 1).long()
    invc = torch.reciprocal(cs_next)
    A5 = A[:, :, None, None, None]

    def scale(k):  # B[:, o_{t+1}] * (1 / c_{t+1}) at step k of every sub-lane: [K, G, NL]
        return B[:, o[rows[:, k]]] * invc[rows[:, k]]

    # Phase 1: Q [K (row j), K (column), G, NL] and E [G, NL].
    Q = torch.eye(K, dtype=_F32, device=dev)[:, :, None, None].expand(K, K, G, NL)
    E = torch.zeros((G, NL), dtype=torch.int32, device=dev)
    for s in range(L):
        k = L - 1 - s
        nQ = seq_sum(A5 * (scale(k)[:, None] * Q)[None], 1)
        Q = torch.where(ok[:, k], nQ, Q)
        if s % 8 == 7:
            r = real[:, k][:, None]
            e = _scale_exp(seq_sum(Q.reshape(K * K, G, NL), 0))
            Q = torch.where(r, Q * _pow2(-e), Q)
            E = torch.where(r, E + e, E)

    # Phase 2: each sub-lane's entering beta.
    has = ok.any(1)
    v, Ev = beta0, torch.zeros(NL, dtype=torch.int32, device=dev)
    starts = [None] * G
    for g in range(G - 1, -1, -1):
        e1 = torch.div(Ev, 2, rounding_mode="trunc")
        e2 = Ev - e1
        starts[g] = (v * _pow2(torch.clamp(e1, -126, 126))) * _pow2(torch.clamp(e2, -126, 126))
        r = seq_sum(Q[:, :, g] * v[None], 1)
        e = _scale_exp(seq_sum(r, 0))
        v = torch.where(has[g], r * _pow2(-e), v)
        Ev = torch.where(has[g], Ev + (E[g] + e), Ev)

    # Phase 3: the chains, t = (g + 1) L - 1 down to g L.
    b = torch.stack(starts, 1)  # [K, G, NL]
    out = [None] * L
    for k in range(L - 1, -1, -1):
        nb = seq_sum(A[:, :, None, None] * (scale(k) * b)[None], 1)
        b = torch.where(ok[:, k], nb, b)
        out[k] = b
    be = torch.stack(out, 0)  # [L, K, G, NL]
    return be.permute(2, 0, 1, 3).reshape(G * L, K, NL)[:Tp].contiguous()


def conf_from_streams(alphas, betas, lens2, mask) -> torch.Tensor:
    """B19's epilogue: conf_t = (sum_k g_k * mask_k) * (1 / max(sum_k g_k,
    1e-30)), g = alphas * betas, 0 past each lane's length -> [Tp, NL]."""
    g = alphas * betas
    tot = torch.clamp_min(seq_sum(g, 1), 1e-30)
    isl = seq_sum(g * mask.to(_F32)[None, :, None], 1)
    valid = torch.arange(g.shape[0], device=g.device)[:, None] < lens2
    return torch.where(valid, isl * torch.reciprocal(tot), 0.0)


def fb_bwd_conf_plain(steps_next, lens2, cs_next, beta0, alphas, mask, A, B,
                      T: int) -> torch.Tensor:
    """Plain version of B19 -> conf [Tp, NL]: B18's sequential betas (B19
    runs one thread a chain at every K) through :func:`conf_from_streams`."""
    betas = _bwd_chain_plain(steps_next, lens2, cs_next, beta0, A, B, T)
    return conf_from_streams(alphas, betas, lens2, mask)


def fb_prod_plain(sel2, tab) -> torch.Tensor:
    """Plain version of B17 -> [K*K, NL], row i*K + m holding C[i, m].

    From the identity, each step takes C <- C . M_{sel_t} (sel >= S: the
    identity row of ``tab``, [S + 1, K*K] from :func:`step_table`); after
    every 8th step (counted from the lane's start) C is multiplied by 1 /
    max(total, 1e-30), the total being the row sums added in order."""
    Tp, NL = sel2.shape
    S = tab.shape[0] - 1
    K = round(tab.shape[1] ** 0.5)
    M_all = tab.reshape(S + 1, K, K)
    sel = torch.clamp(sel2, 0, S).long()
    C = torch.eye(K, dtype=_F32, device=sel2.device)[:, :, None].expand(K, K, NL)
    for t in range(Tp):
        M = M_all[sel[t]].permute(1, 2, 0)  # [m, j, NL]
        C = seq_sum(C[:, :, None, :] * M[None], 1)  # [i, j, NL]
        if t % ROW_TILE == ROW_TILE - 1:
            tot = seq_sum(seq_sum(C, 1), 0)
            C = C * torch.reciprocal(torch.clamp_min(tot, 1e-30))
    return C.reshape(K * K, NL).contiguous()


def fb_stats_plain(alphas, betas, steps2, lens2, B):
    """Plain version of B20 -> (macc [K*K, NL], emit [K*S, NL], ll [1, NL]).

    Over each lane's valid steps: macc[j*K + k] = sum_{t >= 1} ahat_{t-1}[j]
    * (B[k, o_t] * beta_t[k] * (1 / c_t)) with ahat = alpha / c and c_t =
    max(sum_k alpha_t[k], 1e-30); emit[s*K + k] = sum_{o_t = s} gamma_t[k]
    (gamma = normalized alpha * beta); ll = sum_t log c_t.  Time sums as
    tensor reductions."""
    Tp, K, NL = alphas.shape
    S = B.shape[1]
    dev = alphas.device
    vmask = torch.arange(Tp, device=dev)[:, None] < lens2  # [Tp, NL]
    cs = torch.clamp_min(seq_sum(alphas, 1), 1e-30)
    inv_cs = torch.reciprocal(cs)[:, None, :]
    g = alphas * betas
    gamma = torch.where(vmask[:, None, :],
                        g * torch.reciprocal(torch.clamp_min(seq_sum(g, 1), 1e-30))[:, None, :],
                        0.0)
    o = torch.clamp(steps2, 0, S - 1).long()
    emit = torch.cat([torch.where((o == s)[:, None, :], gamma, 0.0).sum(0) for s in range(S)])
    ll = torch.where(vmask, torch.log(cs), 0.0).sum(0)[None, :]
    w = emit_sel(B, o).permute(1, 0, 2) * betas * inv_cs  # [Tp, K, NL]
    pair = vmask.clone()
    pair[0] = False  # t == 0 has no incoming pair
    wm = torch.where(pair[:, None, :], w, 0.0)
    ap = alphas * inv_cs
    macc = torch.stack([(ap[:-1, j : j + 1] * wm[1:]).sum(0) for j in range(K)])
    return macc.reshape(K * K, NL), emit, ll


# ---------------------------------------------------------------------------
# Kernel wrappers


def _check_device(ref: torch.Tensor, tensors) -> None:
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"all operands must share the device {ref.device}")


def _check_stream(name: str, t: torch.Tensor):
    if t.dim() != 2 or 0 in t.shape:
        raise ValueError(f"{name} must be a non-empty [Tp, NL], got {tuple(t.shape)}")
    _check(name, t, _I32, tuple(t.shape))
    return t.shape


def _check_tables(A: torch.Tensor, B: torch.Tensor):
    if B.dim() != 2:
        raise ValueError(f"B must be [K, S], got {tuple(B.shape)}")
    K, S = B.shape
    if not (1 <= K <= MAX_STATES and 1 <= S <= MAX_SYMBOLS):
        raise ValueError(f"dense FB kernels need 1 <= K <= {MAX_STATES} and "
                         f"1 <= S <= {MAX_SYMBOLS}, got K={K}, S={S}")
    _check("A", A, _F32, (K, K))
    _check("B", B, _F32, (K, S))
    return K, S


def fb_fwd(steps2, lens2, a0, A, B) -> torch.Tensor:
    """Kernel B16 (replaces the JAX package's ``_fwd_kernel``) -> alphas
    [Tp, K, NL] f32, the lane in :func:`fwd_sublanes` sub-lanes.  Arguments
    as :func:`fb_fwd_plain`."""
    _check_device(steps2, (lens2, a0, A, B))
    Tp, NL = _check_stream("steps2", steps2)
    K, S = _check_tables(A, B)
    _check("lens2", lens2, _I32, (1, NL))
    _check("a0", a0, _F32, (K, NL))
    if steps2.device.type == "cpu":
        return fb_fwd_plain(steps2, lens2, a0, A, B)
    dev = steps2.device
    G = fwd_sublanes(Tp, K)
    alphas = torch.empty((Tp, K, NL), dtype=_F32, device=dev)
    pbuf = torch.empty((G, K * K, NL) if G > 1 else (1,), dtype=_F32, device=dev)
    _kernels.launch("fb_fwd", steps2, lens2, a0, A, B, alphas, pbuf, Tp=Tp, NL=NL, K=K, S=S,
                    G=G)
    return alphas


def fb_bwd(steps_next, lens2, cs_next, beta0, A, B, T: int) -> torch.Tensor:
    """Kernel B18 (replaces ``_bwd_kernel``) -> betas [Tp, K, NL] f32, the
    lane in :func:`bwd_sublanes` sub-lanes.  Arguments as
    :func:`fb_bwd_plain`."""
    _check_device(steps_next, (lens2, cs_next, beta0, A, B))
    Tp, NL = _check_stream("steps_next", steps_next)
    K, S = _check_tables(A, B)
    _check("lens2", lens2, _I32, (1, NL))
    _check("cs_next", cs_next, _F32, (Tp, NL))
    _check("beta0", beta0, _F32, (K, NL))
    if steps_next.device.type == "cpu":
        return fb_bwd_plain(steps_next, lens2, cs_next, beta0, A, B, T)
    dev = steps_next.device
    G = bwd_sublanes(Tp, K)
    betas = torch.empty((Tp, K, NL), dtype=_F32, device=dev)
    qbuf = torch.empty((G, K * K + 1, NL) if G > 1 else (1,), dtype=_F32, device=dev)
    _kernels.launch("fb_bwd", steps_next, lens2, cs_next, beta0, A, B, betas, qbuf,
                    Tp=Tp, NL=NL, K=K, S=S, T=T, G=G)
    return betas


def fb_bwd_conf(steps_next, lens2, cs_next, beta0, alphas, mask, A, B, T: int) -> torch.Tensor:
    """Kernel B19 (replaces ``_bwd_conf_kernel``) -> conf [Tp, NL] f32; the
    betas never leave the kernel.  Arguments as :func:`fb_bwd_conf_plain`."""
    _check_device(steps_next, (lens2, cs_next, beta0, alphas, mask, A, B))
    Tp, NL = _check_stream("steps_next", steps_next)
    K, S = _check_tables(A, B)
    _check("lens2", lens2, _I32, (1, NL))
    _check("cs_next", cs_next, _F32, (Tp, NL))
    _check("beta0", beta0, _F32, (K, NL))
    _check("alphas", alphas, _F32, (Tp, K, NL))
    _check("mask", mask, _F32, (K,))
    if steps_next.device.type == "cpu":
        return fb_bwd_conf_plain(steps_next, lens2, cs_next, beta0, alphas, mask, A, B, T)
    conf = torch.empty((Tp, NL), dtype=_F32, device=steps_next.device)
    _kernels.launch("fb_bwd_conf", steps_next, lens2, cs_next, beta0, alphas, mask, A, B,
                    conf, Tp=Tp, NL=NL, K=K, S=S, T=T)
    return conf


def fb_prod(sel2, tab) -> torch.Tensor:
    """Kernel B17 (replaces ``_prod_kernel``) -> [K*K, NL] f32.  Arguments
    as :func:`fb_prod_plain`."""
    _check_device(sel2, (tab,))
    Tp, NL = _check_stream("sel2", sel2)
    if tab.dim() != 2:
        raise ValueError(f"tab must be [S + 1, K*K], got {tuple(tab.shape)}")
    S = tab.shape[0] - 1
    K = round(tab.shape[1] ** 0.5)
    if K * K != tab.shape[1] or not (1 <= K <= MAX_STATES and 1 <= S <= MAX_SYMBOLS):
        raise ValueError(f"tab of shape {tuple(tab.shape)}: need [S + 1, K*K] with "
                         f"K <= {MAX_STATES}, 1 <= S <= {MAX_SYMBOLS}")
    _check("tab", tab, _F32, (S + 1, K * K))
    if sel2.device.type == "cpu":
        return fb_prod_plain(sel2, tab)
    out = torch.empty((K * K, NL), dtype=_F32, device=sel2.device)
    _kernels.launch("fb_prod", sel2, tab, out, Tp=Tp, NL=NL, K=K, S=S)
    return out


def fb_stats(alphas, betas, steps2, lens2, B, Tt: int):
    """Kernel B20 (replaces ``_stats_kernel``) -> (macc [K*K, NL], emit
    [K*S, NL], ll [1, NL]).  Arguments as :func:`fb_stats_plain`; the
    kernel reduces each lane in segments of ``Tt`` steps, then sums the
    segments in order (no atomics: the same result every run)."""
    _check_device(steps2, (alphas, betas, lens2, B))
    Tp, NL = _check_stream("steps2", steps2)
    K, S = B.shape if B.dim() == 2 else (0, 0)
    if not (1 <= K <= MAX_STATES and 1 <= S <= MAX_SYMBOLS):
        raise ValueError(f"dense FB kernels need 1 <= K <= {MAX_STATES} and "
                         f"1 <= S <= {MAX_SYMBOLS}, got B of shape {tuple(B.shape)}")
    _check("B", B, _F32, (K, S))
    _check("alphas", alphas, _F32, (Tp, K, NL))
    _check("betas", betas, _F32, (Tp, K, NL))
    _check("lens2", lens2, _I32, (1, NL))
    if Tt <= 0:
        raise ValueError(f"Tt must be positive, got {Tt}")
    if steps2.device.type == "cpu":
        return fb_stats_plain(alphas, betas, steps2, lens2, B)
    dev = steps2.device
    R = K * K + K * S + 1
    part = torch.empty((-(-Tp // Tt), R, NL), dtype=_F32, device=dev)
    macc = torch.empty((K * K, NL), dtype=_F32, device=dev)
    emit = torch.empty((K * S, NL), dtype=_F32, device=dev)
    ll = torch.empty((1, NL), dtype=_F32, device=dev)
    _kernels.launch("fb_stats", alphas, betas, steps2, lens2, B, part, macc, emit, ll,
                    Tp=Tp, NL=NL, K=K, S=S, Tt=Tt)
    return macc, emit, ll


# ---------------------------------------------------------------------------
# Runners (the JAX module's helpers of the same names)


def tables(params: HmmParams):
    """(A, B, pi) as contiguous f32 probability tables on the params' device."""
    if not supports(params):
        raise ValueError(
            f"dense FB kernels need n_states <= {MAX_STATES} and n_symbols <= "
            f"{MAX_SYMBOLS}, got K={params.n_states}, S={params.n_symbols}"
        )
    return tuple(x.to(_F32).contiguous() for x in (params.A, params.B, params.pi))


def _run_fb_kernels(A, B, steps2, lens2, a0_raw, beta0, T: int, conf_mask=None):
    """The forward + backward pair over a [Tp, NL] lane layout.

    a0_raw [K, NL]: each lane's unnormalized v_0 (its sum is that
    position's c); beta0 [K, NL]: each lane's entering beta (ones for
    independent chunks, suffix boundary messages for lanes of one long
    sequence); T: the chunk length (B18's last active step is T - 2).
    Returns (alphas [Tp, K, NL], cs [Tp, NL], betas [Tp, K, NL]); with
    ``conf_mask`` ([K] island indicator) the third element is B19's island
    confidence [Tp, NL] instead.  The scale factors and the time-shifted
    streams are glue shared by the kernel and plain routes, so B18 and B19
    see the same inputs either way."""
    alphas = fb_fwd(steps2, lens2, a0_raw.contiguous(), A, B)
    cs, steps_next, cs_next = backward_inputs(steps2, alphas)
    beta0 = beta0.contiguous()
    if conf_mask is not None:
        mask = torch.as_tensor(conf_mask, dtype=_F32, device=A.device).contiguous()
        return alphas, cs, fb_bwd_conf(steps_next, lens2, cs_next, beta0, alphas, mask, A, B, T)
    return alphas, cs, fb_bwd(steps_next, lens2, cs_next, beta0, A, B, T)


def backward_inputs(steps2, alphas):
    """(cs [Tp, NL], steps_next, cs_next): the scale factors as the row sums
    of B16's output (v_t sums to c_t), and the time-shifted streams B18 and
    B19 read (steps_next[t] = o_{t+1}, cs_next[t] = c_{t+1}; 0 and 1 past
    the end)."""
    NL = steps2.shape[1]
    cs = seq_sum(alphas, 1)
    steps_next = torch.cat([steps2[1:], torch.zeros((1, NL), dtype=_I32, device=steps2.device)])
    cs_next = torch.cat([cs[1:], torch.ones((1, NL), dtype=_F32, device=cs.device)])
    return cs, steps_next, cs_next


def _run_stats_kernel(B, alphas, betas, steps2, lens2, Tt: int):
    """Per-lane counts (B20): (macc [K*K, NL], emit [K*S, NL], ll [1, NL])."""
    return fb_stats(alphas, betas, steps2, lens2, B, Tt)


def _run_products_kernel(A, B, sel2) -> torch.Tensor:
    """Per-lane probability-space transfer products (B17) of a [lane_T, NL]
    PAD-marked step stream -> P [NL, K, K] (P[lane, i, m])."""
    K = A.shape[0]
    out = fb_prod(sel2, step_table(A, B))
    return out.T.reshape(-1, K, K)


def _conf_path_from_streams(alphas, betas, lens2, island_mask):
    """(conf2 [Tp, NL] f32, path2 [Tp, NL] int32) from stored streams: the
    island share of gamma (a division, as the JAX package's want_path
    branch) and the max-posterior-marginal state, first maximum on ties as
    ``jnp.argmax``."""
    Tp = alphas.shape[0]
    vmask = torch.arange(Tp, device=alphas.device)[:, None] < lens2
    graw = alphas * betas
    mask = torch.as_tensor(island_mask, dtype=_F32, device=alphas.device)
    gsum = torch.clamp_min(seq_sum(graw, 1), 1e-30)
    gisl = seq_sum(graw * mask[None, :, None], 1)
    conf2 = torch.where(vmask, gisl / gsum, 0.0)
    best = graw[:, 0]
    arg = torch.zeros(best.shape, dtype=_I32, device=alphas.device)
    for k in range(1, graw.shape[1]):
        take = graw[:, k] > best
        best = torch.where(take, graw[:, k], best)
        arg = torch.where(take, k, arg)
    return conf2, torch.where(vmask, arg, 0).to(_I32)
