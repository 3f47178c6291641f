"""Sequence-parallel forward-backward: the exact whole-sequence E-step and
posterior over a mesh.

Counterpart of ``cpgisland_tpu/parallel/fb_sharded.py``.  The reference's
trainer approximates one long genome as independent 65,536-symbol chunks
(CpGIslandFinder.java:130-141, 200-201); this module computes the exact
statistics of the undivided sequence, split along time over a mesh's
shards, with a boundary-message exchange between them.

The generic lane path (the JAX package's "XLA lane path", any K) lays
each shard out in lanes of ``block_size`` steps, in the same three passes
as the JAX package, each one a loop over the ``block_size`` steps of a
lane vectorized over every lane of the shard:

1. **pass A (operators)**: each lane's normalized product of its step
   matrices S_t = A * B[:, o_t]; an associative scan over the lanes and
   the exchange (:func:`device_boundary_messages`) of the [K, K] shard
   totals give every lane its exact entering-alpha direction;
2. **pass B (forward)**: the scaled forward chains from those directions,
   the alphas and the per-step scales whose logs sum to the loglik;
3. **pass C (backward)**: the suffix products give every lane its exact
   exiting-beta direction; a reverse loop runs the beta recurrence and
   accumulates gamma and xi, each normalized per step, so only the beta
   directions matter (scale-free), or emits the island confidence and the
   max-posterior-marginal state (:func:`_one_seq_local_posterior`).

A step's table row is an index into the [S + 1, K, K] step table (the JAX
package multiplies by a one-hot matrix at HIGHEST precision, which picks
the same float32 rows).  Each sharded function runs in two phases on a
single controller: the local passes on every shard, the exchange (one
gather of each shard's [K] init vector and [K, K] total onto the mesh's
first device, two tiny scans, the messages sent back), then the local
passes that need the messages; the statistics are summed on the first
device in mesh order.  The kernel engines take the same exchange
(``ops.fb_seq``), so both engines run on a mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.ops.viterbi_parallel import associative_scan
from cpgisland_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, check_mesh, make_mesh

DEFAULT_BLOCK = 1024
_TINY = 1e-30
_F32 = torch.float32


def _nrm_v(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.sum(v, dim=-1, keepdim=True), _TINY)


def _nrm_m(m: torch.Tensor) -> torch.Tensor:
    return m / torch.clamp_min(torch.sum(m, dim=(-2, -1), keepdim=True), _TINY)


def _prob_tables(params: HmmParams):
    """Probability-space step tables with a trailing PAD row: Sp_ext[s] =
    A * B[:, s] (A's columns scaled by the emissions) for s < S and the
    identity at S, so PAD steps pass through; B_ext[s] = B[:, s], and ones
    at S."""
    K = params.n_states
    A = params.A.to(_F32)
    B = params.B.to(_F32)  # [K, S]
    Sp = A[None, :, :] * B.T[:, None, :]  # [S, K, K]
    eye = torch.eye(K, dtype=_F32, device=A.device)
    Sp_ext = torch.cat([Sp, eye[None]], dim=0)
    B_ext = torch.cat([B.T, torch.ones((1, K), dtype=_F32, device=A.device)], dim=0)
    return Sp_ext, B_ext


def _select(table: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """Row selection by symbol: ``table[syms]`` (the JAX package's exact
    one-hot matmul picks the same rows; the one-hot itself would cost
    [L, S + 1] floats)."""
    return table[syms]


def _matmul_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized batched matrix product, the (+, x) semiring combine."""
    return _nrm_m(torch.matmul(a, b))


def _scan(P: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of lane products over dim 0 with the combination
    tree of ``jax.lax.associative_scan``; ``reverse`` gives the suffix
    products P[n] . P[n+1] . ... (flip, scan with the combine's operands
    swapped, flip back, as JAX does)."""
    if not reverse:
        return associative_scan(lambda a, b: [_matmul_combine(a[0], b[0])], [P])[0]
    rev = associative_scan(lambda a, b: [_matmul_combine(b[0], a[0])], [P.flip(0)])[0]
    return rev.flip(0)


def device_boundary_messages(a0_locals, totals, start_dir=None, end_dir=None):
    """The cross-shard boundary-message exchange (the ONE implementation,
    shared by the lane path and the kernel path of ``ops.fb_seq``).

    ``a0_locals``: each shard's [K] init vector (only shard 0's is read);
    ``totals``: each shard's [K, K] normalized transfer total, in mesh
    order, each on its shard's device.  They are gathered onto shard 0's
    device, where a prefix scan gives every shard its entering-alpha
    direction and a suffix scan its exiting-beta direction; each result
    goes back to its shard's device.  ``start_dir`` / ``end_dir`` thread
    span boundaries: the prefix scan starts from ``start_dir`` in place of
    shard 0's init direction (the entering message from the previous
    span), the suffix scan from ``end_dir`` in place of the free end's
    uniform direction (the exiting message from the next span).

    Returns (a0_raw [K] on shard 0's device, enter_dirs, exit_dirs: lists
    of [K], one per shard on its device)."""
    devs = [t.device for t in totals]
    dev0 = devs[0]
    a0_raw = a0_locals[0]
    a0n = _nrm_v(a0_raw)
    tot = torch.stack([t.to(dev0, non_blocking=True) for t in totals])  # [D, K, K]
    D, K = tot.shape[0], tot.shape[1]
    v = a0n if start_dir is None else _nrm_v(
        torch.as_tensor(start_dir, dtype=_F32).to(dev0) + a0n * 0.0)
    enters = []
    for d in range(D):
        enters.append(v)
        v = _nrm_v(torch.matmul(v, tot[d]))
    if end_dir is None:
        b = torch.full((K,), 1.0 / K, dtype=_F32, device=dev0)
    else:
        b = torch.as_tensor(end_dir, dtype=_F32).to(dev0)
    b = _nrm_v(b + a0n * 0.0)
    exits = [None] * D
    for d in reversed(range(D)):
        exits[d] = b
        b = _nrm_v(torch.matmul(tot[d], b))
    return (a0_raw,
            [e.to(dv, non_blocking=True) for e, dv in zip(enters, devs)],
            [x.to(dv, non_blocking=True) for x, dv in zip(exits, devs)])


def _lane_pass_products(params: HmmParams, obs_shard: torch.Tensor, length: int, *, d: int,
                        block_size: int, first: bool = True) -> dict:
    """Pass A and the lane layout of shard ``d`` (the ONE copy of the
    packing and masking math): each lane's normalized operator product and
    their inclusive prefix.  ``obs_shard`` [L] (L a multiple of
    ``block_size``; PAD >= n_symbols allowed past ``length``, the count of
    real symbols in this shard).  ``first``: the span starts the sequence,
    so shard 0's position 0 is the init (its step the identity, its
    emission folded into v0).  Read by :func:`_one_seq_lane_setup` and by
    the span transfer totals of ``parallel.posterior``."""
    K, M = params.n_states, params.n_symbols
    L = obs_shard.shape[0]
    if L % block_size:
        raise ValueError(f"shard of {L} symbols is not a multiple of block_size={block_size}")
    nb = L // block_size
    dev = obs_shard.device
    A = params.A.to(_F32)
    Sp_ext, B_ext = _prob_tables(params)

    obs_c = torch.clamp_max(obs_shard.long(), M)  # stray values clamp to PAD
    pos = torch.arange(L, device=dev)
    pos_valid = pos < int(length)
    # The global init's emission folds into v0, so its step is the identity.
    step_valid = pos_valid & ~((pos == 0) & (d == 0 and first))
    sel_sym = torch.where(step_valid, obs_c, M)
    emit_sym = torch.where(pos_valid, torch.clamp_max(obs_c, M - 1), 0)

    def to2(x):  # [bs, nb]: lane b covers positions [b * bs, (b + 1) * bs)
        return x.reshape(nb, block_size).T.contiguous()

    sel2, emit2 = to2(sel_sym), to2(emit_sym)
    sv2, pv2 = to2(step_valid), to2(pos_valid)
    # index_select: a 0-dim index tensor would be read on the host.
    v0_local = params.pi.to(_F32) * B_ext.index_select(0, torch.clamp_max(obs_c[:1], M - 1))[0]

    eye_b = torch.eye(K, dtype=_F32, device=dev).expand(nb, K, K)
    C = eye_b
    for t in range(block_size):
        C = _nrm_m(torch.matmul(C, _select(Sp_ext, sel2[t])))
    return dict(K=K, M=M, nb=nb, d=d, A=A, B_ext=B_ext, eye_b=eye_b, sel2=sel2, emit2=emit2,
                sv2=sv2, pv2=pv2, P_lane=C, incl=_scan(C), v0_local=v0_local,
                length=int(length), first=bool(first))


def _one_seq_lane_setup(params: HmmParams, lay: dict, v0_raw: torch.Tensor,
                        v_enter_dev: torch.Tensor, beta_exit_dev: torch.Tensor) -> dict:
    """Pass B and the exiting-beta directions of one shard, from its pass A
    layout ``lay`` and its messages from the exchange (``v0_raw``: shard
    0's init vector; ``v_enter_dev`` / ``beta_exit_dev``: this shard's
    entering-alpha and exiting-beta directions).  Consumed by the stats
    pass and the posterior pass."""
    K, nb, d = lay["K"], lay["nb"], lay["d"]
    A, B_ext, sel2, sv2 = lay["A"], lay["B_ext"], lay["sel2"], lay["sv2"]
    incl = lay["incl"]
    bs = sel2.shape[0]
    excl = torch.cat([lay["eye_b"][:1], incl[:-1]], dim=0)
    enters = _nrm_v(torch.matmul(v_enter_dev, excl))  # [nb, K]

    alphas = torch.empty((bs, nb, K), dtype=_F32, device=A.device)
    cs = torch.empty((bs, nb), dtype=_F32, device=A.device)
    alpha = enters
    for t in range(bs):
        raw = torch.matmul(alpha, A) * _select(B_ext, sel2[t])
        c = torch.sum(raw, dim=-1)
        new = raw / torch.clamp_min(c, _TINY)[:, None]
        alpha = torch.where(sv2[t][:, None], new, alpha)
        alphas[t] = alpha
        cs[t] = torch.where(sv2[t], c, 1.0)
    # The init's folded-emission scale belongs to shard 0 of a first span,
    # and only when it observed a symbol (an all-padding stream has
    # loglik 0); a continuation span's logliks are direction-relative.
    loglik = torch.sum(torch.where(sv2, torch.log(cs), 0.0))
    if d == 0 and lay["first"] and lay["length"] > 0:
        loglik = loglik + torch.log(torch.clamp_min(torch.sum(v0_raw), _TINY))

    Rsuf = _scan(lay["P_lane"], reverse=True)
    beta_exits = torch.cat([_nrm_v(torch.matmul(Rsuf[1:], beta_exit_dev[:, None])[..., 0]),
                            beta_exit_dev[None]], dim=0)  # [nb, K]
    return dict(lay, enters=enters, alphas=alphas, loglik=loglik, beta_exits=beta_exits)


def _betas_reverse(s: dict):
    """The reverse beta recurrence of pass C: yields (t, beta_t) for t =
    bs-1 .. 0 (each lane's last step takes its exiting direction)."""
    A, B_ext, sel2, sv2 = s["A"], s["B_ext"], s["sel2"], s["sv2"]
    AT = A.T
    beta = s["beta_exits"]
    bs = sel2.shape[0]
    yield bs - 1, beta
    for t in range(bs - 2, -1, -1):
        w = _select(B_ext, sel2[t + 1]) * beta
        beta = torch.where(sv2[t + 1][:, None], _nrm_v(torch.matmul(w, AT)), beta)
        yield t, beta


def _one_seq_local_stats(params: HmmParams, s: dict) -> SuffStats:
    """Pass C of one shard: its (unsummed) statistics from the setup ``s``.
    gamma_t = normalize(alpha_t * beta_t); xi of the pair (t-1 -> t),
    owned by position t, is normalized by its own total, so the beta
    directions give the exact counts; lane 0's pair uses the lane's
    entering direction (the pair the chunked trainer drops), and the
    global init has none."""
    K, M, nb = s["K"], s["M"], s["nb"]
    A, B_ext, alphas, enters = s["A"], s["B_ext"], s["alphas"], s["enters"]
    emit2, sv2, pv2 = s["emit2"], s["sv2"], s["pv2"]
    dev = A.device
    trans_acc = torch.zeros((nb, K, K), dtype=_F32, device=dev)
    emit_acc = torch.zeros((nb, K, M), dtype=_F32, device=dev)
    beta_first = None
    for t, beta in _betas_reverse(s):
        gamma = _nrm_v(alphas[t] * beta)
        # Emissions from the real symbols (emit2), not the step symbols.
        emit_acc.scatter_add_(2, emit2[t][:, None, None].expand(nb, K, 1),
                              torch.where(pv2[t][:, None], gamma, 0.0)[:, :, None])
        aprev = enters if t == 0 else alphas[t - 1]
        xr = aprev[:, :, None] * A[None] * (_select(B_ext, emit2[t]) * beta)[:, None, :]
        xi = xr / torch.clamp_min(torch.sum(xr, dim=(-2, -1), keepdim=True), _TINY)
        trans_acc = trans_acc + torch.where(sv2[t][:, None, None], xi, 0.0)
        beta_first = beta
    gamma0 = _nrm_v(alphas[0, 0] * beta_first[0])
    at_init = s["d"] == 0 and s["length"] > 0
    return SuffStats(
        init=gamma0 if at_init else torch.zeros_like(gamma0),
        trans=torch.sum(trans_acc, dim=0),
        emit=torch.sum(emit_acc, dim=0),
        loglik=s["loglik"],
        n_seqs=torch.full((), int(at_init), dtype=torch.int32, device=dev),
    )


def _one_seq_local_posterior(params: HmmParams, s: dict, island_mask, *,
                             want_path: bool = False):
    """Pass C of one shard as a posterior: per position conf[t] = the
    gamma mass on the island states and, with ``want_path``, the
    max-posterior-marginal state (first maximum), both 0 past the shard's
    real symbols.  Returns (conf [L] f32, path [L] int32 — zeros without
    ``want_path``) in the shard's position order."""
    nb, alphas, pv2 = s["nb"], s["alphas"], s["pv2"]
    bs = alphas.shape[0]
    dev = alphas.device
    mask = torch.as_tensor(island_mask, dtype=_F32).to(dev)
    conf2 = torch.empty((bs, nb), dtype=_F32, device=dev)
    path2 = torch.zeros((bs, nb), dtype=torch.int32, device=dev)
    for t, beta in _betas_reverse(s):
        gamma = _nrm_v(alphas[t] * beta)
        conf2[t] = torch.where(pv2[t], torch.sum(gamma * mask[None, :], dim=-1), 0.0)
        if want_path:
            path2[t] = torch.where(pv2[t], torch.argmax(gamma, dim=-1), 0).to(torch.int32)
    return conf2.T.reshape(-1), path2.T.reshape(-1)


def shard_params(params: HmmParams, shards) -> list:
    """The model on each shard's device, copied once a call (without a
    blocking read: the copies queue on the streams)."""
    by_dev = {str(params.device): params}
    out = []
    for s in shards:
        key = str(s.device)
        if key not in by_dev:
            by_dev[key] = HmmParams(*(x.to(s.device, non_blocking=True) for x in
                                      (params.log_pi, params.log_A, params.log_B)))
        out.append(by_dev[key])
    return out


def lane_setups(params: HmmParams, shards, lengths, *, block_size: int, first: bool = True,
                enter_dir=None, exit_dir=None):
    """Passes A and B over every shard with the exchange between them:
    yields each shard's setup in mesh order (the later shards' pass B runs
    as the caller consumes the earlier ones, so one shard's alphas live at
    a time).  A continuation span (``first=False``) needs ``enter_dir``."""
    if not first and enter_dir is None:
        raise ValueError("continuation spans (first=False) need enter_dir — the "
                         "entering-alpha direction from the previous span")
    ps = shard_params(params, shards)
    lays = [_lane_pass_products(p, o, n, d=d, block_size=block_size, first=first)
            for d, (p, o, n) in enumerate(zip(ps, shards, lengths))]
    v0_raw, enters, exits = device_boundary_messages(
        [lay["v0_local"] for lay in lays], [lay["incl"][-1] for lay in lays],
        start_dir=None if first else enter_dir, end_dir=exit_dir)
    for d, lay in enumerate(lays):
        lays[d] = None
        yield _one_seq_lane_setup(ps[d], lay, v0_raw, enters[d], exits[d])


def sum_stats(stats) -> SuffStats:
    """Per-shard statistics summed on the first shard's device, in mesh
    order (the port's psum)."""
    dev = stats[0].init.device
    total = stats[0]
    for st in stats[1:]:
        total = total + SuffStats(*(x.to(dev, non_blocking=True) for x in
                                    (st.init, st.trans, st.emit, st.loglik, st.n_seqs)))
    return total


def lane_stats(params: HmmParams, shards, lengths, *,
               block_size: int = DEFAULT_BLOCK) -> SuffStats:
    """Exact whole-sequence statistics of ONE sequence split over
    ``shards`` (tensors [L] in mesh order, each on its device; ``lengths``
    the real-symbol counts per shard, host ints) through the lane path,
    summed on the first shard's device."""
    return sum_stats([_one_seq_local_stats(params, s) for s in
                      lane_setups(params, shards, lengths, block_size=block_size)])


def lane_posterior(params: HmmParams, shards, lengths, island_mask, *,
                   block_size: int = DEFAULT_BLOCK, first: bool = True, enter_dir=None,
                   exit_dir=None, want_path: bool = False) -> list:
    """Per-shard (conf, path) of one span through the lane path (see
    :func:`_one_seq_local_posterior`), with the span-boundary messages
    ``enter_dir`` / ``exit_dir``."""
    return [_one_seq_local_posterior(params, s, island_mask, want_path=want_path)
            for s in lane_setups(params, shards, lengths, block_size=block_size, first=first,
                                 enter_dir=enter_dir, exit_dir=exit_dir)]


def lane_transfer_total(params: HmmParams, shards, lengths, *, block_size: int = DEFAULT_BLOCK,
                        first: bool = True) -> torch.Tensor:
    """A span's normalized [K, K] probability-space transfer operator
    through pass A: every shard's lane products, their totals composed in
    mesh order on the first shard's device (the JAX ``_transfer_total_fn``)."""
    ps = shard_params(params, shards)
    totals = [_lane_pass_products(p, o, n, d=d, block_size=block_size, first=first)["incl"][-1]
              for d, (p, o, n) in enumerate(zip(ps, shards, lengths))]
    dev0 = totals[0].device
    C = torch.eye(params.n_states, dtype=_F32, device=dev0)
    for t in totals:
        C = _nrm_m(torch.matmul(C, t.to(dev0, non_blocking=True)))
    return C


def entry_symbols(shards, lengths, S: int, prev0: int) -> list:
    """The symbol emitted before each shard (the reduced engines condition
    a chain's entry group on it): the last real symbol of the nearest
    earlier shard that has one (clamped below S, as the lanes clamp it),
    else ``prev0``.  One element read per shard."""
    out, last = [], int(prev0)
    for o, n in zip(shards, lengths):
        out.append(last)
        if int(n) > 0:
            last = min(int(o[int(n) - 1]), S - 1)
    return out


# ---------------------------------------------------------------------------
# Layouts and placement


def shard_sequence(obs: np.ndarray, n_shards: int, block_size: int = DEFAULT_BLOCK,
                   pad_value: int = 4):
    """Split one symbol stream into per-device shards (padded, with
    lengths): (obs_padded [n_shards * L] uint8, lengths [n_shards] int32),
    L a multiple of ``block_size``."""
    obs = np.ascontiguousarray(obs, dtype=np.uint8)
    T = obs.shape[0]
    quantum = n_shards * block_size
    padded_T = max(quantum, ((T + quantum - 1) // quantum) * quantum)
    if padded_T != T:
        obs = np.concatenate([obs, np.full(padded_T - T, pad_value, dtype=np.uint8)])
    L = padded_T // n_shards
    lengths = np.clip(T - np.arange(n_shards) * L, 0, L).astype(np.int32)
    return obs, lengths


def shard_lengths(seq_lengths: np.ndarray, T_padded: int, sp: int) -> np.ndarray:
    """Per-(sequence, seq-shard) real-symbol counts: [N] -> [N, sp]."""
    L = T_padded // sp
    starts = np.arange(sp) * L
    return np.clip(np.asarray(seq_lengths)[:, None] - starts[None, :], 0, L).astype(np.int32)


def pad_batch2d(chunks: np.ndarray, lengths: np.ndarray, dp: int, sp: int, block_size: int,
                pad_value: int):
    """Pad an [N, T] sequence batch for a dp x sp split: rows to a multiple
    of dp with zero-length rows, columns to a multiple of sp * block_size
    with ``pad_value``.  Returns the inputs themselves when no padding is
    needed."""
    chunks = np.asarray(chunks)
    lengths = np.asarray(lengths)
    n, T = chunks.shape
    quantum = sp * block_size
    T_pad = max(quantum, -(-T // quantum) * quantum)
    n_pad = -(-n // dp) * dp
    if (n_pad, T_pad) == (n, T):
        return chunks, lengths.astype(np.int32)
    obs = np.full((n_pad, T_pad), pad_value, dtype=np.uint8)
    obs[:n, :T] = chunks
    out_lengths = np.zeros(n_pad, np.int32)
    out_lengths[:n] = lengths
    return obs, out_lengths


def pack_ragged(sequences, pad_value: int):
    """Pack ragged 1-D symbol arrays into a padded [N, T_max] matrix and
    their lengths."""
    if len(sequences) == 0:
        raise ValueError("no sequences")
    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    rows = np.full((len(sequences), max(1, int(lengths.max()))), pad_value, dtype=np.uint8)
    for i, s in enumerate(sequences):
        rows[i, : len(s)] = np.asarray(s, dtype=np.uint8)
    return rows, lengths


def place_shards(mesh: Mesh, obs_p: np.ndarray) -> tuple:
    """Upload a padded stream [D * L] (from :func:`shard_sequence`) as D
    shards [L], shard d on the mesh's d-th device."""
    from cpgisland_tpu_torch.utils import chunking

    devs = mesh.device_list
    parts = np.asarray(obs_p).reshape(len(devs), -1)
    return tuple(chunking.upload(parts[d], dev) for d, dev in enumerate(devs))


def place_batch2d(mesh: Mesh, chunks: np.ndarray, lengths: np.ndarray):
    """Upload a padded [N, T] batch onto a 2-D (data x seq) mesh: tile
    (i, j) holds rows [i * N / dp, (i + 1) * N / dp) and columns
    [j * T / sp, (j + 1) * T / sp) on device (i, j).  Returns (tiles — a
    tuple of dp tuples of sp tensors —, lengths2d [N, sp] int32 on the
    host)."""
    from cpgisland_tpu_torch.utils import chunking

    dp, sp = mesh.devices.shape
    chunks = np.asarray(chunks)
    N, T = chunks.shape
    rows, cols = N // dp, T // sp
    tiles = tuple(tuple(chunking.upload(np.ascontiguousarray(
        chunks[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]), mesh.devices[i, j])
        for j in range(sp)) for i in range(dp))
    return tiles, shard_lengths(np.asarray(lengths), T, sp)


# ---------------------------------------------------------------------------
# Entry points over a mesh


def _check_layout(mesh: Mesh, shape: tuple) -> None:
    if tuple(shape) != tuple(mesh.devices.shape):
        raise ValueError(f"placed layout {tuple(shape)} does not match the mesh "
                         f"{tuple(mesh.devices.shape)}; place the input on this mesh")


def sharded_stats_fn(mesh: Mesh, block_size: int):
    """fn(params, shards, lengths) -> SuffStats on the mesh's first device:
    the lane path over a 1-D mesh (``shards``: one [L] tensor per mesh
    entry, on its device, L a multiple of ``block_size``; ``lengths``:
    host ints)."""

    def fn(params, shards, lengths):
        _check_layout(mesh, (len(shards),))
        return lane_stats(params, shards, lengths, block_size=block_size)

    return fn


def sharded_stats_pallas_fn(mesh: Mesh, lane_T: int, onehot: bool = False,
                            fused: bool = True, one_pass: bool = False):
    """Kernel twin of :func:`sharded_stats_fn` (same contract, plus the
    per-shard preps and entry symbols): every shard's lane products, the
    exchange, then every shard's chains and statistics through the kernels
    (``ops.fb_seq.seq_stats_sharded``: B7, B4, B5, or B17, B16, B18)."""
    from cpgisland_tpu_torch.ops import fb_seq

    def fn(params, shards, lengths, prepared=None, entry_syms=None):
        _check_layout(mesh, (len(shards),))
        return sum_stats(fb_seq.seq_stats_sharded(
            params, shards, lengths, lane_T=lane_T, engine="onehot" if onehot else "pallas",
            prepared=prepared, entry_syms=entry_syms, one_pass=one_pass, fused=fused))

    return fn


def sharded_stats2d_fn(mesh: Mesh, block_size: int, engine: str = "xla",
                       lane_T: Optional[int] = None, one_pass: bool = False):
    """fn(params, tiles, lengths2d) -> SuffStats: a batch of whole
    sequences on a 2-D (data x seq) mesh (the layout of
    :func:`place_batch2d`): every row is one sequence over its data row's
    seq shards, through the lane path (``engine="xla"``) or the kernels
    with the exchange; the statistics summed in row order on the first
    device.  ``prepared``: one (per-shard preps, entry symbols) pair per
    row, in row order (kernel engines)."""
    from cpgisland_tpu_torch.ops import fb_seq

    def fn(params, tiles, lengths2d, prepared=None):
        _check_layout(mesh, (len(tiles), len(tiles[0])))
        per_row = []
        R = tiles[0][0].shape[0]
        for i, row_tiles in enumerate(tiles):
            for r in range(R):
                shards = [t[r] for t in row_tiles]
                lens = [int(x) for x in lengths2d[i * R + r]]
                if engine == "xla":
                    per_row.append(lane_stats(params, shards, lens, block_size=block_size))
                    continue
                preps, ents = (None, None) if prepared is None else prepared[i * R + r]
                lt = lane_T or fb_seq.pick_lane_T(shards[0].shape[0])
                per_row.append(sum_stats(fb_seq.seq_stats_sharded(
                    params, shards, lens, lane_T=lt, engine=engine, prepared=preps,
                    entry_syms=ents, one_pass=one_pass)))
        return sum_stats(per_row)

    return fn


def sharded_stats2d_rows_fn(mesh: Mesh, engine: str, t_tile: int = 512):
    """Whole-record rows on a 2-D mesh whose seq axis is trivial: each data
    row's records, one per lane of the chunked E-step (exact: a record
    that fits a lane needs no boundary messages), on its device; the
    statistics summed on the first device.  fn(params, tiles, lens2d,
    prepared=None), ``prepared``: one chunked prep per data row (built
    here in tiles of ``t_tile`` steps when not given)."""
    from cpgisland_tpu_torch.ops import fb_chunked, forward_backward
    from cpgisland_tpu_torch.ops.prepared import prepare_chunked

    def fn(params, tiles, lengths2d, prepared=None):
        _check_layout(mesh, (len(tiles), len(tiles[0])))
        ps = shard_params(params, [row[0] for row in tiles])
        R = tiles[0][0].shape[0]
        out = []
        for i, row in enumerate(tiles):
            lens = torch.from_numpy(np.ascontiguousarray(
                lengths2d[i * R:(i + 1) * R, 0])).to(row[0].device)
            if engine == "xla":
                out.append(forward_backward.batch_stats(ps[i], row[0], lens, mode="rescaled"))
            else:
                prep = (prepare_chunked(params.n_symbols, row[0], lens, t_tile=t_tile,
                                        onehot=engine == "onehot")
                        if prepared is None else prepared[i])
                out.append(fb_chunked.batch_stats(ps[i], row[0], lens, prepared=prep,
                                                  engine=engine))
        return sum_stats(out)

    return fn


def seq_stats_sharded(params: HmmParams, obs, *, mesh: Optional[Mesh] = None,
                      block_size: int = DEFAULT_BLOCK) -> SuffStats:
    """Exact whole-sequence statistics of one sequence, split along time
    over a mesh, through the lane path: the "one long genome" alternative
    to the chunked ``ops.forward_backward.batch_stats`` (the same
    SuffStats contract).  ``mesh`` default: one entry on the params'
    device."""
    mesh = check_mesh(mesh) or make_mesh(axis=SEQ_AXIS, device=params.device)
    obs_p, lengths = shard_sequence(np.asarray(obs), mesh.size, block_size, params.n_symbols)
    shards = place_shards(mesh, obs_p)
    return sharded_stats_fn(mesh, block_size)(params, shards, [int(n) for n in lengths])


def batch_seq_stats_sharded(params: HmmParams, sequences, *, mesh: Mesh,
                            block_size: int = DEFAULT_BLOCK) -> SuffStats:
    """Exact statistics of a batch of independent sequences on a 2-D mesh:
    the sequences over the mesh's data axis, each one's time over its seq
    axis; the result is the SUM of the per-sequence whole-sequence
    statistics."""
    mesh = check_mesh(mesh)
    if mesh is None or len(mesh.axis_names) != 2:
        raise ValueError(f"need a 2-D (data, seq) mesh, got {mesh}")
    dp, sp = mesh.devices.shape
    pad = params.n_symbols
    rows, seq_lengths = pack_ragged(list(sequences), pad)
    obs, lengths = pad_batch2d(rows, seq_lengths, dp, sp, block_size, pad)
    tiles, lens2d = place_batch2d(mesh, obs, lengths)
    return sharded_stats2d_fn(mesh, block_size, "xla")(params, tiles, lens2d)
