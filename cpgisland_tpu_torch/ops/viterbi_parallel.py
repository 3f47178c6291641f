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

Three engines supply the passes (:func:`get_passes`): "xla", the plain
PyTorch twins below (any K; the JAX package's non-kernel engine); "pallas",
the dense kernels for K <= 8 (ops.viterbi_pallas, CUDA kernels B13-B15 on
the card); and "onehot", the reduced kernels for one-hot-emission models
(ops.viterbi_onehot, B1-B3).  The dense engines perform the same float32
adds and maxes as each other, so they agree bit for bit.  The stitching is
plain PyTorch and performs the same float32 operations in the same order as
the JAX package, including the combination tree of its associative scan, so
the two agree bit for bit on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cpgisland_tpu_torch.models.hmm import LOG_ZERO, HmmParams

# Legacy default kept for parity with the JAX package; not yet retuned for
# the card.
DEFAULT_BLOCK = 4096

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
    # want_scores=True only (onehot engine): per-block entering offsets and the
    # block-normalized per-step chain max, the flat batch decoder's score feed.
    enter_offs: Optional[torch.Tensor] = None  # [nb]
    dmax2: Optional[torch.Tensor] = None  # [bk, nb]


def _enter_vectors(v_enter0: torch.Tensor, incl: torch.Tensor, offs=None):
    """Normalized per-block entering score vectors from the exclusive
    prefix, plus (with ``offs``) the per-block true-score offsets.

    v_enter0 [..., K] and incl [nb, ..., K, K]: the leading dims after the
    block axis are independent records (the dense batch decoder), each
    computed exactly as alone."""
    K = v_enter0.shape[-1]
    ident = _identity_logmat(K, incl.device).expand(incl.shape[1:])[None]
    excl = torch.cat([ident, incl[:-1]], dim=0)
    v = torch.amax(v_enter0[None, ..., :, None] + excl, dim=-2)  # [nb, ..., K]
    vmax = torch.amax(v, dim=-1)
    v = torch.clamp_min(v - vmax[..., None], LOG_ZERO)
    if offs is None:
        return v
    excl_off = torch.cat([torch.zeros_like(offs[:1]), offs[:-1]])
    return v, vmax + excl_off


def _suffix_compositions(F: torch.Tensor) -> torch.Tensor:
    """Gsuf[b] = F_b ∘ F_{b+1} ∘ ... (later-in-time tables applied first).
    Integer-valued, so the scan order cannot change the result."""
    rev = associative_scan(lambda a, b: [_compose(b[0], a[0])], [F.flip(0)])[0]
    return rev.flip(0)


# ---------------------------------------------------------------------------
# The "xla" engine: plain PyTorch twins of the JAX package's lax.scan passes.
# Step matrices are selected by an index gather of M_ext (the JAX twin's
# one-hot matmul at HIGHEST precision returns the same float32 values).


def _products_scan(M_ext: torch.Tensor, steps2: torch.Tensor) -> torch.Tensor:
    """Each lane's max-plus product of its block's step matrices: steps2
    [bk, nb] -> [nb, K, K] (PAD rows of M_ext are the identity)."""
    K = M_ext.shape[-1]
    C = _identity_logmat(K, steps2.device).expand(steps2.shape[1], K, K)
    for k in range(steps2.shape[0]):
        C = maxplus_matmul(C, M_ext[steps2[k].long()])
    return C


def _backpointers_scan(M_ext: torch.Tensor, v_enter: torch.Tensor, steps2: torch.Tensor,
                       emit):
    """The delta recursion from the entering vectors v_enter [nb, K]:
    argmax backpointers (first max on ties, as ``jnp.argmax``) and the
    exit -> entry composition E'[j] = E[bp[j]].  Returns (delta [nb, K],
    F [nb, K] int32, [emit(bp) for each step]) with bp [nb, K] int64."""
    nb, K = v_enter.shape
    delta = v_enter
    E = torch.arange(K, device=v_enter.device).expand(nb, K)
    rows = []
    for k in range(steps2.shape[0]):
        scores = delta[:, :, None] + M_ext[steps2[k].long()]  # [nb, from, to]
        bp = torch.argmax(scores, dim=1)
        delta = torch.amax(scores, dim=1)
        E = torch.gather(E, 1, bp)
        rows.append(emit(bp))
    return delta, E.to(torch.int32), rows


def lane_products(params: HmmParams, steps2: torch.Tensor) -> torch.Tensor:
    """Per-lane block products [nb, K, K] before the prefix scan."""
    M_ext, _ = _step_tables(params)
    return _products_scan(M_ext, steps2)


def _pass_products(params: HmmParams, steps2: torch.Tensor, prev0=None):
    """Pass A (xla twin): (incl, offs, total).  ``prev0`` is consumed only
    by the onehot engine; the dense engines ignore it."""
    incl, offs = scan_block_products(lane_products(params, steps2))
    return incl, offs, incl[-1]


def _pass_backpointers(params: HmmParams, v_enter: torch.Tensor, steps2: torch.Tensor,
                       prev0=None):
    """Pass B (xla twin): (delta_exit [nb, K], F [nb, K], bps [bk, nb, K]
    int8)."""
    M_ext, _ = _step_tables(params)
    delta, F, rows = _backpointers_scan(M_ext, v_enter, steps2,
                                        lambda bp: bp.to(torch.int8))
    return delta, F, torch.stack(rows)


def _pass_backtrace(bps: torch.Tensor, exits: torch.Tensor) -> torch.Tensor:
    """Pass C (xla twin): walk the backpointers from each lane's exit state,
    emitting the state after each step.  Returns [bk * nb] in global step
    order."""
    bk, nb, _ = bps.shape
    state = exits.long()
    path2 = torch.empty((bk, nb), dtype=torch.int32, device=bps.device)
    for k in range(bk - 1, -1, -1):
        path2[k] = state
        state = torch.gather(bps[k], 1, state[:, None])[:, 0].long()
    return path2.T.reshape(-1)


def get_passes(engine: str):
    """The block-pass triple (products, backpointers, backtrace) of an
    engine: 'xla' (the twins above), 'pallas' (ops.viterbi_pallas, K <= 8)
    or 'onehot' (ops.viterbi_onehot; needs prev0).  The backpointer blob
    is engine-specific and flows opaquely into the backtrace."""
    if engine == "xla":
        return _pass_products, _pass_backpointers, _pass_backtrace
    if engine == "pallas":
        from cpgisland_tpu_torch.ops import viterbi_pallas

        return (
            viterbi_pallas.pass_products,
            viterbi_pallas.pass_backpointers,
            viterbi_pallas.pass_backtrace,
        )
    if engine == "onehot":
        from cpgisland_tpu_torch.ops import viterbi_onehot

        return (
            viterbi_onehot.pass_products,
            viterbi_onehot.pass_backpointers,
            viterbi_onehot.pass_backtrace,
        )
    raise ValueError(f"unknown engine {engine!r}; expected xla|pallas|onehot")


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
    want_scores: bool = False,
) -> BlockDecode:
    """Run the three block passes over ``steps`` (transition symbols, a
    positive multiple of block_size long, PAD allowed) with ``v_enter0``
    the score vector entering the first step.  path[k] = state after step k,
    anchored at the segment end to ``anchor`` if given, else to the local
    argmax.  ``resets`` ([bk, nb] bool) marks steps that restart the chain at
    a new record (the flat batch decoder); ``pre`` is a prepared pair
    stream (viterbi_onehot.prepare_pairs).  ``want_scores`` (onehot engine
    only) runs the backpointer pass through B6 and fills ``enter_offs`` and
    ``dmax2``, so callers can read true chain maxima at any step."""
    products, backpointers, backtrace = get_passes(engine)
    nb = steps.shape[0] // block_size
    steps2 = steps.reshape(nb, block_size).T  # [bk, nb]: step b*bk + k at [k, b]

    extra = {}
    if resets is not None:
        if engine != "onehot":
            raise ValueError("record-reset steps need the onehot engine")
        extra["resets"] = resets
    if pre is not None:
        if engine != "onehot":
            raise ValueError("prepared pair streams need the onehot engine")
        extra["pre"] = pre
    incl, offs, total = products(params, steps2, prev0, **extra)
    v_enter, enter_offs = _enter_vectors(v_enter0, incl, offs)
    dmax2 = None
    if want_scores:
        if engine != "onehot":
            raise ValueError("want_scores needs the onehot engine")
        from cpgisland_tpu_torch.ops import viterbi_onehot

        delta_blocks, F, bps, dmax2 = viterbi_onehot.pass_backpointers_scores(
            params, v_enter, steps2, prev0, **extra)
    else:
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
        enter_offs=enter_offs if want_scores else None, dmax2=dmax2,
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
    for the reduced chain); parallel.decode demotes such records to a dense
    engine."""
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


def _lane_products_fn(engine: str):
    """The dense engine's per-lane block products (before the prefix scan)."""
    if engine == "pallas":
        from cpgisland_tpu_torch.ops import viterbi_pallas

        return viterbi_pallas.lane_products
    return lane_products


def _dense_batch(params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                 block_size: int, return_score: bool, engine: str):
    """Every record of the batch decoded as by :func:`viterbi_parallel`
    alone (the JAX package's vmap), with all records' blocks side by side
    as the lanes of one launch per pass.  Record r's block b is lane
    r * nb + b; the prefix scans, stitching and anchors run batched over
    records, each record's exactly as alone, so the result equals the
    per-record decode bit for bit."""
    _, backpointers, backtrace = get_passes(engine)
    N, T = chunks.shape
    dev = params.device
    K, pad_sym = params.n_states, params.n_symbols
    obs_c = torch.where(
        torch.arange(T, device=dev)[None, :] >= lengths.to(dev)[:, None],
        pad_sym,
        torch.clamp_max(chunks.to(device=dev, dtype=torch.int32), pad_sym),
    ).to(torch.int32)
    _, emit_ext = _step_tables(params)
    v0 = params.log_pi[None, :] + emit_ext[obs_c[:, 0].long()]  # [N, K]
    if T == 1:
        path = torch.argmax(v0, dim=-1).to(torch.int32)[:, None]
        return (path, torch.amax(v0, dim=-1)) if return_score else path

    S = T - 1
    bk = min(block_size, max(8, S))
    nb = -(-S // bk)
    steps = torch.cat([
        obs_c[:, 1:],
        torch.full((N, nb * bk - S), pad_sym, dtype=torch.int32, device=dev),
    ], dim=1)
    steps2 = steps.reshape(N * nb, bk).T  # [bk, N*nb]: record r's step b*bk + k at [k, r*nb + b]

    P = _lane_products_fn(engine)(params, steps2).reshape(N, nb, K, K).transpose(0, 1)
    incl, offs = scan_block_products(P)  # [nb, N, K, K], [nb, N]
    v_enter, enter_offs = _enter_vectors(v0, incl, offs)  # [nb, N, K]
    delta_blocks, F, bps = backpointers(
        params, v_enter.transpose(0, 1).reshape(N * nb, K), steps2, None)
    delta_exit = delta_blocks.reshape(N, nb, K)[:, -1]  # [N, K]
    s_exit = torch.argmax(delta_exit, dim=-1)  # [N]
    Gsuf = _suffix_compositions(F.reshape(N, nb, K).transpose(0, 1))  # [nb, N, K]
    exits = torch.cat([
        torch.gather(Gsuf[1:], 2, s_exit[None, :, None].expand(nb - 1, N, 1))[..., 0],
        s_exit[None, :].to(torch.int32),
    ])  # [nb, N]
    path = backtrace(bps, exits.T.reshape(-1)).reshape(N, nb * bk)
    s0 = torch.gather(Gsuf[0], 1, s_exit[:, None])  # [N, 1] entry states
    full = torch.cat([s0.to(torch.int32), path[:, :S]], dim=1)
    if not return_score:
        return full
    return full, torch.amax(delta_exit, dim=-1) + enter_offs[-1]


def viterbi_parallel_batch(
    params: HmmParams,
    chunks: torch.Tensor,
    lengths: torch.Tensor,
    block_size: Optional[int] = None,
    return_score: bool = True,
    engine: str = "onehot",
):
    """Batched decode of a [N, T] batch of padded chunks (paths [N, T];
    positions >= lengths[i] are forced to PAD and carry the exit state),
    with per-record scores [N] when ``return_score``.

    Onehot batches run FLAT (viterbi_onehot.decode_batch_flat): records
    concatenate into one stream with rank-one RESET steps at record
    boundaries, so every kernel runs at single-stream occupancy; records
    need at least 2 symbols, and the scores come off the flat stream
    through B6.  The dense engines ('xla', 'pallas') decode each record
    exactly as alone (:func:`_dense_batch`).  ``block_size=None`` means
    DEFAULT_BLOCK with or without scores: the port has no tuner table."""
    block_size = DEFAULT_BLOCK if block_size is None else int(block_size)
    if engine != "onehot":
        get_passes(engine)  # raises on an unknown engine
        return _dense_batch(params, chunks, lengths, block_size, return_score, engine)
    from cpgisland_tpu_torch.ops.viterbi_onehot import decode_batch_flat

    return decode_batch_flat(params, chunks, lengths, block_size=block_size,
                             return_score=return_score)
