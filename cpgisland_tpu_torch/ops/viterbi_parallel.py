"""Parallel Viterbi: blockwise max-plus scan with composition backtrace.

Counterpart of ``cpgisland_tpu/ops/viterbi_parallel.py``.  A timestep of the
HMM DP is a max-plus matrix-vector product and max-plus matrix products are
associative, so a T-step recurrence becomes three block passes over
``n_blocks`` parallel lanes of ``block_size`` sequential steps each:

1. **products** — each lane's max-plus product of its block's step
   matrices; an exclusive prefix over the block products gives every
   block's exact entering score vector;
2. **backpointers** — lanes re-scan their block from the true entering
   vector, emitting backpointers and the block's exit -> entry composition
   table;
3. **backtrace** — a cross-block composition anchors every block's exit
   state to the global argmax, then lanes walk their backpointers.

Only the reduced one-hot engine is ported (ops.viterbi_onehot, whose three
passes are CUDA kernels on the card).  The stitching below is plain PyTorch
and performs the same float32 operations in the same order as the JAX
package, including the combination tree of its associative scan, so the
two agree bit for bit on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cpgisland_tpu_torch.models.hmm import LOG_ZERO, HmmParams

# Legacy default kept for parity with the JAX package; not yet retuned for
# the card.
DEFAULT_BLOCK = 4096

NOT_PORTED = (
    "the dense decode engines ('xla', 'pallas') are not ported to PyTorch "
    "yet; this package decodes only models eligible for the reduced one-hot "
    "engine, and only records whose first symbol is a real base"
)


def _identity_logmat(K: int, device) -> torch.Tensor:
    eye = torch.eye(K, dtype=torch.bool, device=device)
    return torch.where(eye, 0.0, LOG_ZERO).to(torch.float32)


def _step_tables(params: HmmParams):
    """Per-symbol step matrices with a trailing identity for the PAD
    sentinel: M_ext[s][i, j] = logA[i, j] + logB[j, s]; emit_ext maps PAD
    to a zero emission row."""
    K = params.n_states
    M = params.log_A[None, :, :] + params.log_B.T[:, None, :]  # [S, K, K]
    M_ext = torch.cat([M, _identity_logmat(K, params.device)[None]], dim=0)
    emit_ext = torch.cat(
        [params.log_B.T, torch.zeros((1, K), dtype=torch.float32, device=params.device)],
        dim=0,
    )
    return M_ext, emit_ext


def maxplus_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x (+,max) y)[..., i, j] = max_m x[..., i, m] + y[..., m, j]."""
    return torch.amax(x[..., :, :, None] + y[..., None, :, :], dim=-2)


def nrm_maxplus(m: torch.Tensor) -> torch.Tensor:
    """Shift a max-plus matrix so its max entry is 0 (f32 range guard:
    unnormalized chains reach magnitudes where the f32 ulp exceeds the
    per-state score differences).  Decision-invariant within a lane."""
    return torch.clamp_min(m - torch.amax(m, dim=(-2, -1), keepdim=True), LOG_ZERO)


def nrm_maxplus_vec(v: torch.Tensor) -> torch.Tensor:
    """The [K] score-vector twin of :func:`nrm_maxplus`."""
    return torch.clamp_min(v - torch.amax(v, dim=-1, keepdim=True), LOG_ZERO)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = torch.empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]),
                      dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems: list) -> list:
    """Inclusive scan along dim 0 with the combination tree of
    ``jax.lax.associative_scan``: combine adjacent pairs, recurse, then fix
    up the even positions.  A combine that rounds (the normalized max-plus
    product) gives the JAX package's float32 results only in this order."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def scan_block_products(P: torch.Tensor):
    """Inclusive prefix of per-block max-plus products, NORMALIZED per
    combine.  Returns (incl [nb, K, K] with per-matrix max 0, offs [nb] the
    subtracted offsets — true incl[b] = incl[b] + offs[b])."""
    mx0 = torch.amax(P, dim=(-2, -1))
    P0 = torch.clamp_min(P - mx0[..., None, None], LOG_ZERO)

    def comb(a, b):
        m = maxplus_matmul(a[0], b[0])
        mx = torch.amax(m, dim=(-2, -1))
        return [torch.clamp_min(m - mx[..., None, None], LOG_ZERO), a[1] + b[1] + mx]

    incl, offs = associative_scan(comb, [P0, mx0])
    return incl, offs


def _compose(earlier: torch.Tensor, later: torch.Tensor) -> torch.Tensor:
    """Composition of state->state lookup tables: out[s] = earlier[later[s]]
    (the later-in-time table applies first — the backtrace order)."""
    return torch.gather(earlier, -1, later.long()).to(torch.int32)


class BlockDecode(NamedTuple):
    """Everything segment-stitching layers need from a blockwise decode."""

    path: torch.Tensor  # [S] int32 — state after each step
    delta_exit: torch.Tensor  # [K] final score vector (normalized; see offset)
    total: torch.Tensor  # [K, K] normalized max-plus product of all steps
    ftable: torch.Tensor  # [K] int32 — maps segment exit state -> entry state
    score_offset: torch.Tensor  # [] add to delta_exit for true scores


def _enter_vectors(v_enter0: torch.Tensor, incl: torch.Tensor, offs=None):
    """Normalized per-block entering score vectors from the exclusive
    prefix, plus (with ``offs``) the per-block true-score offsets."""
    K = v_enter0.shape[0]
    excl = torch.cat([_identity_logmat(K, incl.device)[None], incl[:-1]], dim=0)
    v = torch.amax(v_enter0[None, :, None] + excl, dim=1)  # [nb, K]
    vmax = torch.amax(v, dim=-1)
    v = torch.clamp_min(v - vmax[:, None], LOG_ZERO)
    if offs is None:
        return v
    excl_off = torch.cat([torch.zeros_like(offs[:1]), offs[:-1]])
    return v, vmax + excl_off


def _suffix_compositions(F: torch.Tensor) -> torch.Tensor:
    """Gsuf[b] = F_b ∘ F_{b+1} ∘ ... (later-in-time tables applied first).
    Integer-valued, so the scan order cannot change the result."""
    rev = associative_scan(lambda a, b: [_compose(b[0], a[0])], [F.flip(0)])[0]
    return rev.flip(0)


def get_passes(engine: str):
    """The block-pass triple (products, backpointers, backtrace) of an
    engine.  Only 'onehot' (ops.viterbi_onehot) is ported."""
    if engine == "onehot":
        from cpgisland_tpu_torch.ops import viterbi_onehot

        return (
            viterbi_onehot.pass_products,
            viterbi_onehot.pass_backpointers,
            viterbi_onehot.pass_backtrace,
        )
    if engine in ("xla", "pallas"):
        raise NotImplementedError(NOT_PORTED)
    raise ValueError(f"unknown engine {engine!r}; expected onehot")


def _block_passes(
    params: HmmParams,
    v_enter0: torch.Tensor,
    steps: torch.Tensor,
    block_size: int,
    anchor: Optional[torch.Tensor] = None,
    engine: str = "onehot",
    prev0: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    pre=None,
) -> BlockDecode:
    """Run the three block passes over ``steps`` (transition symbols, a
    positive multiple of block_size long, PAD allowed) with ``v_enter0``
    the score vector entering the first step.  path[k] = state after step k,
    anchored at the segment end to ``anchor`` if given, else to the local
    argmax.  ``resets`` ([bk, nb] bool) marks steps that restart the chain at
    a new record (the flat batch decoder); ``pre`` is a prepared pair
    stream (viterbi_onehot.prepare_pairs)."""
    products, backpointers, backtrace = get_passes(engine)
    nb = steps.shape[0] // block_size
    steps2 = steps.reshape(nb, block_size).T  # [bk, nb]: step b*bk + k at [k, b]

    extra = {}
    if resets is not None:
        extra["resets"] = resets
    if pre is not None:
        extra["pre"] = pre
    incl, offs, total = products(params, steps2, prev0, **extra)
    v_enter, enter_offs = _enter_vectors(v_enter0, incl, offs)
    delta_blocks, F, bps = backpointers(params, v_enter, steps2, prev0, **extra)
    delta_exit = delta_blocks[-1]

    s_exit = torch.argmax(delta_exit).to(torch.int32) if anchor is None else anchor
    Gsuf = _suffix_compositions(F)
    # exits[b] for b < nb-1 = (F_{b+1} ∘ ... ∘ F_{nb-1})[s_exit].
    exits = torch.cat([Gsuf[1:, :][:, s_exit.long()], s_exit[None]])
    path = backtrace(bps, exits)
    return BlockDecode(
        path=path, delta_exit=delta_exit, total=total, ftable=Gsuf[0],
        score_offset=enter_offs[-1],
    )


def viterbi_parallel(
    params: HmmParams,
    obs: torch.Tensor,
    block_size: int = DEFAULT_BLOCK,
    return_score: bool = True,
    engine: str = "onehot",
):
    """Exact Viterbi path via the blockwise parallel scan (one device).

    PAD symbols (>= n_symbols) are pass-through identity steps.  The onehot
    engine needs obs[0] < n_symbols (a PAD first symbol has no entry group
    for the reduced chain); parallel.decode refuses such records."""
    _, emit_ext = _step_tables(params)
    obs = obs.to(device=params.device, dtype=torch.int32)
    T = obs.shape[0]
    pad_sym = params.n_symbols
    obs_c = torch.clamp_max(obs, pad_sym)

    v0 = params.log_pi + emit_ext[obs_c[0].long()]
    if T == 1:
        path = torch.argmax(v0).to(torch.int32)[None]
        return (path, torch.amax(v0)) if return_score else path

    S = T - 1
    bk = min(block_size, max(8, S))
    nb = -(-S // bk)
    padded = torch.cat([
        obs_c[1:],
        torch.full((nb * bk - S,), pad_sym, dtype=torch.int32, device=obs.device),
    ])
    dec = _block_passes(params, v0, padded, bk, engine=engine, prev0=obs_c[0])

    # path[0] (time 0) = entry state of the whole segment.
    s0 = dec.ftable[torch.argmax(dec.delta_exit)]
    path = torch.cat([s0[None], dec.path[:S]])
    if not return_score:
        return path
    return path, torch.amax(dec.delta_exit) + dec.score_offset


def viterbi_parallel_batch(
    params: HmmParams,
    chunks: torch.Tensor,
    lengths: torch.Tensor,
    block_size: Optional[int] = None,
    return_score: bool = True,
    engine: str = "onehot",
):
    """Batched decode of a [N, T] batch of padded chunks (paths [N, T];
    positions >= lengths[i] carry the exit state).

    Onehot batches run FLAT (viterbi_onehot.decode_batch_flat): records
    concatenate into one stream with rank-one RESET steps at record
    boundaries, so every kernel runs at single-stream occupancy.  Records
    need at least 2 symbols; per-record scores need the score-threading
    backpointer kernel, not ported yet."""
    if engine != "onehot":
        get_passes(engine)  # raises: not ported / unknown
    if return_score:
        raise NotImplementedError(
            "per-record scores from the flat batch need the score-threading "
            "backpointer kernel, not ported yet; pass return_score=False"
        )
    from cpgisland_tpu_torch.ops.viterbi_onehot import decode_batch_flat

    block_size = DEFAULT_BLOCK if block_size is None else int(block_size)
    return decode_batch_flat(params, chunks, lengths, block_size=block_size)
