"""Forward-backward and per-chunk Baum-Welch sufficient statistics: the
generic K-state engine in plain torch, and the E-step's output contract.

Counterpart of ``cpgisland_tpu/ops/forward_backward.py``: the E-step
"mapper" of the reference's trainer (Mahout's Baum-Welch mappers run scaled
forward-backward over one 65,536-symbol chunk and emit expected counts,
CpGIslandFinder.java:200-201; the "rescaling" numerics flag at :92).  This
is the engine the JAX router calls "xla": any K, any alphabet, either
numerics.  The kernels of ``ops/fb_chunked.py`` (the reduced and the dense
engines) fill the same :class:`SuffStats`.

- ``mode="rescaled"`` (the default): Rabiner per-step rescaling in
  probability space, the reference's numerics.
- ``mode="log"``: log-semiring recurrences (logsumexp).  In float32 its
  gammas come from ``exp(alpha + beta - loglik)``, a cancellation of terms
  of order 1.3 T, so on long chunks it tracks a float64 oracle less
  closely than the rescaled mode.

The chains loop over time with every step vectorized over the chunks of a
batch, on the caller's device; the backward pass accumulates the counts as
it goes, so nothing of size T x K x K is stored.  A padded chunk (symbol ==
PAD >= n_symbols past its length) contributes nothing: pad steps are
identity steps excluded from the counts, and an empty chunk gives exactly
zero statistics.  The scoring entry :func:`sequence_loglik` runs through
the lane-parallel kernels of ``ops/loglik.py`` for the models they take,
else through the serial chain here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cpgisland_tpu_torch.models.hmm import LOG_ZERO, HmmParams
# The scoring entry: the lane-parallel kernels for the models they take,
# else sequence_loglik_serial below.
from cpgisland_tpu_torch.ops.loglik import sequence_loglik  # noqa: F401

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SuffStats:
    """Expected-count sufficient statistics (the mapper output contract),
    tensors on the E-step's device.

    init:  [K]    expected count of starting in state i        (gamma_0)
    trans: [K, K] expected i->j transition counts              (sum_t xi_t)
    emit:  [K, S] expected state-i-emits-s counts              (sum_t gamma_t [o_t = s])
    loglik: []    total log-likelihood of the chunk(s)
    n_seqs: []    number of (non-empty) sequences accumulated
    """

    init: torch.Tensor
    trans: torch.Tensor
    emit: torch.Tensor
    loglik: torch.Tensor
    n_seqs: torch.Tensor

    @staticmethod
    def zeros(n_states: int, n_symbols: int, device="cpu") -> "SuffStats":
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
        return SuffStats(init=z(n_states), trans=z(n_states, n_states),
                         emit=z(n_states, n_symbols), loglik=z(),
                         n_seqs=torch.zeros((), dtype=torch.int32, device=device))

    def __add__(self, other: "SuffStats") -> "SuffStats":
        return SuffStats(*(getattr(self, f.name) + getattr(other, f.name)
                           for f in dataclasses.fields(self)))


def _masks(params: HmmParams, obs: torch.Tensor, lengths: torch.Tensor):
    """(obs_c [N, T] long, clamped and 0 off the real positions; valid
    [N, T] bool: the positions before each chunk's length)."""
    T = obs.shape[1]
    valid = torch.arange(T, device=obs.device)[None, :] < lengths.long()[:, None]
    obs_c = torch.where(valid, torch.clamp_max(obs.long(), params.n_symbols - 1), 0)
    return obs_c, valid


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The JAX package's logsumexp: the max clamped at LOG_ZERO, so an
    all-LOG_ZERO slice stays finite."""
    m = torch.clamp_min(torch.max(x, dim=dim, keepdim=True).values, LOG_ZERO)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def _emit_add(emit_acc: torch.Tensor, gamma: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """emit_acc[n, :, o[n]] += gamma[n, :] (a one-hot product's sum)."""
    N, K, S = emit_acc.shape
    return emit_acc.scatter_add(2, o[:, None, None].expand(N, K, 1), gamma[:, :, None])


def _finish(params: HmmParams, init, trans, emit, loglik, lengths) -> SuffStats:
    """Per-chunk results [N, ...] -> their sum; an empty chunk adds zeros."""
    nonempty = lengths > 0
    z = lambda x: torch.where(nonempty.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
    return SuffStats(init=torch.sum(z(init), 0), trans=torch.sum(z(trans), 0),
                     emit=torch.sum(z(emit), 0), loglik=torch.sum(z(loglik), 0),
                     n_seqs=torch.sum(nonempty.to(torch.int32)))


def _chunk_stats_log(params: HmmParams, obs: torch.Tensor, lengths: torch.Tensor):
    K, S = params.n_states, params.n_symbols
    obs_c, valid = _masks(params, obs, lengths)
    N, T = obs_c.shape
    log_A, emit_t = params.log_A.to(_F32), params.log_B.to(_F32).T  # [S, K]
    # Forward: alpha[t] = log P(o_0..o_t, s_t); pad steps are identity.
    alpha = torch.where(valid[:, :1], params.log_pi.to(_F32)[None] + emit_t[obs_c[:, 0]],
                        LOG_ZERO)
    alphas = [alpha]
    for t in range(1, T):
        new = _logsumexp(alpha[:, :, None] + log_A, 1) + emit_t[obs_c[:, t]]
        alpha = torch.where(valid[:, t : t + 1], new, alpha)
        alphas.append(alpha)
    loglik = _logsumexp(alpha, 1)  # [N]
    # Backward with the counts accumulated as it goes.
    beta = torch.zeros((N, K), dtype=_F32, device=obs.device)
    trans = torch.zeros((N, K, K), dtype=_F32, device=obs.device)
    emit = torch.zeros((N, K, S), dtype=_F32, device=obs.device)
    for t in range(T - 2, -1, -1):
        v_next, v_t = valid[:, t + 1], valid[:, t]
        w = emit_t[obs_c[:, t + 1]] + beta  # [N, K]
        contrib = alphas[t][:, :, None] + log_A + w[:, None, :] - loglik[:, None, None]
        trans = trans + torch.where(v_next[:, None, None], torch.exp(contrib), 0.0)
        beta_t = _logsumexp(log_A + w[:, None, :], 2)
        beta = torch.where(v_next[:, None], beta_t, beta)
        gamma = torch.exp(alphas[t] + beta - loglik[:, None])
        gamma = torch.where(v_t[:, None], gamma, 0.0)
        emit = _emit_add(emit, gamma, obs_c[:, t])
    # The reverse loop covered t = 0..T-2, which includes the last real
    # position of a padded chunk; only a full chunk leaves t = T-1 out.
    gamma_last = torch.exp(alpha - loglik[:, None])
    emit = _emit_add(emit, torch.where((lengths == T)[:, None], gamma_last, 0.0),
                     obs_c[:, T - 1])
    gamma0 = torch.exp(alphas[0] + beta - loglik[:, None])
    return _finish(params, gamma0, trans, emit, loglik, lengths)


def _rescaled_forward(params: HmmParams, obs_c: torch.Tensor, valid: torch.Tensor):
    """The Rabiner-rescaled forward pass of every chunk -> (alphas [T] list
    of [N, K], cs [N, T]); pad steps are identity (alpha passes through, c
    = 1)."""
    K = params.n_states
    A, B_t, pi = params.A.to(_F32), params.B.to(_F32).T, params.pi.to(_F32)
    N, T = obs_c.shape
    a0_raw = torch.where(valid[:, :1], pi[None] * B_t[obs_c[:, 0]],
                         torch.full((N, K), 1.0 / K, dtype=_F32, device=obs_c.device))
    c = torch.sum(a0_raw, 1)
    alpha = a0_raw / c[:, None]
    alphas, cs = [alpha], [c]
    for t in range(1, T):
        raw = (alpha @ A) * B_t[obs_c[:, t]]
        c = torch.sum(raw, 1)
        v = valid[:, t]
        alpha = torch.where(v[:, None], raw / c[:, None], alpha)
        alphas.append(alpha)
        cs.append(torch.where(v, c, 1.0))
    return alphas, torch.stack(cs, 1)


def _chunk_stats_rescaled(params: HmmParams, obs: torch.Tensor, lengths: torch.Tensor):
    K, S = params.n_states, params.n_symbols
    obs_c, valid = _masks(params, obs, lengths)
    N, T = obs_c.shape
    A, B_t = params.A.to(_F32), params.B.to(_F32).T
    alphas, cs = _rescaled_forward(params, obs_c, valid)
    loglik = torch.sum(torch.where(valid, torch.log(cs), 0.0), 1)
    beta = torch.ones((N, K), dtype=_F32, device=obs.device)
    trans = torch.zeros((N, K, K), dtype=_F32, device=obs.device)
    emit = torch.zeros((N, K, S), dtype=_F32, device=obs.device)
    for t in range(T - 2, -1, -1):
        v_next, v_t = valid[:, t + 1], valid[:, t]
        w = B_t[obs_c[:, t + 1]] * beta / cs[:, t + 1 : t + 2]  # [N, K]
        xi = alphas[t][:, :, None] * A * w[:, None, :]
        trans = trans + torch.where(v_next[:, None, None], xi, 0.0)
        beta = torch.where(v_next[:, None], w @ A.T, beta)
        gamma = alphas[t] * beta
        gamma = gamma / torch.clamp_min(torch.sum(gamma, 1, keepdim=True), 1e-30)
        gamma = torch.where(v_t[:, None], gamma, 0.0)
        emit = _emit_add(emit, gamma, obs_c[:, t])
    # Same boundary accounting as the log numerics.
    alphaT = alphas[-1]
    gamma_last = alphaT / torch.clamp_min(torch.sum(alphaT, 1, keepdim=True), 1e-30)
    emit = _emit_add(emit, torch.where((lengths == T)[:, None], gamma_last, 0.0),
                     obs_c[:, T - 1])
    gamma0 = alphas[0] * beta
    gamma0 = gamma0 / torch.clamp_min(torch.sum(gamma0, 1, keepdim=True), 1e-30)
    return _finish(params, gamma0, trans, emit, loglik, lengths)


def _check_mode(mode: str) -> None:
    if mode not in ("log", "rescaled"):
        raise ValueError(f"unknown numerics mode: {mode!r}")


def batch_stats(params: HmmParams, chunks, lengths, mode: str = "log") -> SuffStats:
    """The statistics of a [N, T] batch of padded chunks (``lengths`` [N]),
    summed over the chunks: the reference's mapper (per-chunk
    forward-backward) and combiner (count summation) on one device, in
    either numerics.  The "xla" E-step engine of ``train.backends``."""
    _check_mode(mode)
    dev = params.device
    chunks = torch.as_tensor(chunks).to(dev)
    lengths = torch.as_tensor(lengths).to(dev)
    if chunks.shape[1] == 0:
        return SuffStats.zeros(params.n_states, params.n_symbols, device=dev)
    fn = _chunk_stats_log if mode == "log" else _chunk_stats_rescaled
    return fn(params, chunks, lengths)


def chunk_stats(params: HmmParams, obs, length, mode: str = "log") -> SuffStats:
    """The sufficient statistics of one padded chunk ``obs`` [T] with
    ``length`` real symbols (the E-step mapper)."""
    obs = torch.as_tensor(obs).to(params.device)
    return batch_stats(params, obs[None], torch.as_tensor(length).reshape(1), mode=mode)


def sequence_loglik_serial(params: HmmParams, obs, length: Optional[int] = None) -> torch.Tensor:
    """log P(obs[:length] | params) of one sequence by the JAX package's
    serial forward chain (rescaled numerics), a float32 0-d tensor: the
    scoring entry for the models outside the kernels' domains.  PAD is
    positional: a symbol >= n_symbols, or a position at or past
    ``length``, is an identity step (no transition, no emission), a PAD
    first position included; an impossible observation scores -inf, never
    nan."""
    obs = torch.as_tensor(obs).to(params.device).long()
    T = obs.shape[0]
    if T == 0:
        return torch.zeros((), dtype=_F32, device=params.device)
    length = T if length is None else int(length)
    valid = (torch.arange(T, device=obs.device) < length) & (obs < params.n_symbols)
    obs_c = torch.where(valid, obs, 0)
    A, B_t, pi = params.A.to(_F32), params.B.to(_F32).T, params.pi.to(_F32)
    a0_raw = torch.where(valid[0], pi * B_t[obs_c[0]], pi)
    c0 = torch.sum(a0_raw)
    alpha = torch.where(c0 > 0, a0_raw / torch.where(c0 > 0, c0, 1.0), pi)
    cs = []
    for t in range(1, T):
        raw = (alpha @ A) * B_t[obs_c[t]]
        c = torch.sum(raw)
        ok = valid[t] & (c > 0)
        alpha = torch.where(ok, raw / torch.where(c > 0, c, 1.0), alpha)
        cs.append(torch.where(valid[t], c, 1.0))
    ll0 = torch.where(valid[0], torch.log(c0), 0.0)
    if not cs:
        return ll0
    tail = torch.stack(cs)
    return ll0 + torch.sum(torch.where(valid[1:], torch.log(tail), 0.0))
