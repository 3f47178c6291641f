"""Dense blockwise Viterbi engine ("pallas"): three CUDA kernels and their
plain PyTorch versions.

Counterpart of ``cpgisland_tpu/ops/viterbi_pallas.py``.  Same three passes
as ops.viterbi_parallel (products -> backpointers -> backtrace) for any
model with K <= 8 states, with the per-step loops as hand-written kernels
(``csrc/viterbi_dense.cu``) over the time-major [bk, nb] step stream: one
thread per lane for the backpointers, one warp per segment of 32 lanes for
the backtrace (segments joined by exact K-state maps), one row of the
K x K product per thread for the products on up to 8 Ki lanes (one
thread per lane past them), the product rows or the K-state delta in
registers, and every step's matrix M_t[m, j] = logA[m, j] + logB[j, o_t]
looked up in a per-symbol table (the identity for PAD).  All K backpointers of a step
pack into one int32 (3 bits per state), so the backtrace state machine is
``state = (packed >> 3 * state) & 7``, and the exit -> entry composition
table threads through the same packing.

Each kernel wrapper launches its kernel for a CUDA tensor, takes the plain
PyTorch version for a CPU tensor, and raises otherwise.  Max-plus is adds
and maxes only, and the kernels keep the twin's operands (the step entry
logA + logB first, the chain value added after), so kernel, plain version
and the "xla" twin agree bit for bit, first-max tie-breaking included.
The prefix scan between the passes is the shared scan_block_products.
"""

from __future__ import annotations

import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops.viterbi_parallel import (
    DEFAULT_BLOCK,
    _backpointers_scan,
    _identity_logmat,
    _products_scan,
    scan_block_products,
)

MAX_PACK_STATES = 8  # 3-bit packing: state ids 0..7 -> one int32 per step
MAX_SYMBOLS = 255  # symbols are bytes; the kernels' step table has S + 1 rows

# Identity exit->entry table, 3-bit packed: bits [3j, 3j+3) hold j.
PACKED_IDENTITY = 0
for _j in range(MAX_PACK_STATES):
    PACKED_IDENTITY |= _j << (3 * _j)
del _j

_I32 = torch.int32
_F32 = torch.float32


def supports(params: HmmParams) -> bool:
    """Kernel eligibility: the 3-bit backpointer packing needs K <= 8."""
    return params.n_states <= MAX_PACK_STATES


def _require_support(params: HmmParams) -> None:
    if not supports(params):
        raise ValueError(
            f"viterbi_pallas packs backpointers 3 bits/state: needs "
            f"n_states <= {MAX_PACK_STATES}, got {params.n_states}"
        )


def _shifts(K: int, device) -> torch.Tensor:
    return 3 * torch.arange(K, dtype=_I32, device=device)


def _step_table(logAT: torch.Tensor, logB: torch.Tensor) -> torch.Tensor:
    """[S + 1, K, K] step matrices from the kernels' operands: row s < S is
    M_s[m, j] = logA[m, j] + logB[j, s] (logAT[j, m] = logA[m, j]), row S
    the max-plus identity (PAD)."""
    K = logAT.shape[0]
    M = logAT.T[None, :, :] + logB.T[:, None, :]
    return torch.cat([M, _identity_logmat(K, logAT.device)[None]], dim=0)


# ---------------------------------------------------------------------------
# The three kernels: plain PyTorch versions and the wrappers that launch the
# CUDA kernels.  Shapes are the kernels' own: steps2 [bk, nb] int32 (PAD =
# any value >= S), logAT [K, K] (transposed transitions), logB [K, S].


def dense_products_plain(steps2: torch.Tensor, logAT: torch.Tensor,
                         logB: torch.Tensor) -> torch.Tensor:
    """Pass A, plain version: each lane's max-plus product of its block's
    step matrices -> [K * K, nb], row i * K + m holding product[i, m]."""
    K = logAT.shape[0]
    steps = torch.clamp_max(steps2, logB.shape[1])
    P = _products_scan(_step_table(logAT, logB), steps)
    return P.reshape(-1, K * K).T.contiguous()


def dense_backpointers_plain(steps2: torch.Tensor, v_enter: torch.Tensor,
                             logAT: torch.Tensor, logB: torch.Tensor):
    """Pass B, plain version: the delta recursion from the entering vectors
    v_enter [K, nb].  Returns (bp [bk, nb] int32: step k's K pointers at 3
    bits each, dexit [K, nb] f32, ftab [nb] int32: the packed exit -> entry
    table)."""
    K = logAT.shape[0]
    sh = _shifts(K, steps2.device)
    pack = lambda t: (t.to(_I32) << sh).sum(dim=-1, dtype=_I32)  # disjoint bits
    steps = torch.clamp_max(steps2, logB.shape[1])
    delta, F, rows = _backpointers_scan(_step_table(logAT, logB), v_enter.T, steps, pack)
    return torch.stack(rows), delta.T.contiguous(), pack(F)


def dense_backtrace_plain(bp: torch.Tensor, exits: torch.Tensor) -> torch.Tensor:
    """Pass C, plain version: walk the packed pointers back from each lane's
    exit state, emitting the state after each step -> path [bk, nb] int32."""
    bk, nb = bp.shape
    path = torch.empty((bk, nb), dtype=_I32, device=bp.device)
    state = exits.to(_I32)
    for k in range(bk - 1, -1, -1):
        path[k] = state
        state = (bp[k] >> (3 * state)) & 7
    return path


def dense_backtrace_sub_plain(bp: torch.Tensor, exits: torch.Tensor, K: int,
                              seg: int) -> torch.Tensor:
    """B15's walk as the kernel splits it, plain version (for the tests):
    each lane's bk steps in G = ceil(bk / seg) segments of ``seg`` steps,
    [s seg, min((s + 1) seg, bk)).  Each segment's map (the state below its
    first step from each of the K states at its last, packed 3 bits an
    entry as a pointer word) is walked from all K states without the state
    that enters it; the exit state goes through the maps of the segments
    above to each segment's last step, and each segment then walks as
    :func:`dense_backtrace_plain` does.  Returns path [bk, nb], equal to
    that one walk's for pointers and exit states below K."""
    bk, nb = bp.shape
    G = max(1, -(-bk // seg))
    bounds = [(s * seg, min((s + 1) * seg, bk)) for s in range(G)]
    maps = []
    for k_lo, k_hi in bounds:
        f = torch.arange(K, dtype=_I32, device=bp.device)[:, None].expand(K, nb)
        for k in range(k_hi - 1, k_lo - 1, -1):
            f = (bp[k][None, :] >> (3 * f)) & 7
        maps.append((f << _shifts(K, bp.device)[:, None]).sum(dim=0, dtype=_I32))
    path = torch.empty((bk, nb), dtype=_I32, device=bp.device)
    state = exits.to(_I32)
    tops = [None] * G
    for s in range(G - 1, -1, -1):
        tops[s] = state
        state = (maps[s] >> (3 * state)) & 7
    for (k_lo, k_hi), state in zip(bounds, tops):
        for k in range(k_hi - 1, k_lo - 1, -1):
            path[k] = state
            state = (bp[k] >> (3 * state)) & 7
    return path


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})"
        )


def _check_operands(first: torch.Tensor, others) -> None:
    if first.dim() != 2 or first.shape[0] == 0 or first.shape[1] == 0:
        raise ValueError(f"expected a non-empty [bk, nb] stream, got {tuple(first.shape)}")
    for t in others:
        if t.device != first.device:
            raise ValueError(f"all operands must share the stream's device {first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")


def _check_tables(logAT: torch.Tensor, logB: torch.Tensor):
    K, S = logB.shape
    if not 1 <= K <= MAX_PACK_STATES or not 1 <= S <= MAX_SYMBOLS:
        raise ValueError(f"dense kernels need 1 <= K <= {MAX_PACK_STATES} and "
                         f"1 <= S <= {MAX_SYMBOLS}, got K={K}, S={S}")
    _check("logAT", logAT, _F32, (K, K))
    _check("logB", logB, _F32, (K, S))
    return K, S


def dense_products(steps2: torch.Tensor, logAT: torch.Tensor,
                   logB: torch.Tensor) -> torch.Tensor:
    """Kernel B13 (replaces the JAX package's ``_products_kernel``):
    [bk, nb] steps -> [K * K, nb] block products, one row of a lane's
    product per thread up to 8 Ki lanes, one thread per lane past them."""
    _check_operands(steps2, (logAT, logB))
    K, S = _check_tables(logAT, logB)
    bk, nb = steps2.shape
    _check("steps2", steps2, _I32, (bk, nb))
    if steps2.device.type == "cpu":
        return dense_products_plain(steps2, logAT, logB)
    out = torch.empty((K * K, nb), dtype=_F32, device=steps2.device)
    _kernels.launch("dense_products", steps2, logAT, logB, out, bk=bk, nb=nb, K=K, S=S)
    return out


def dense_backpointers(steps2: torch.Tensor, v_enter: torch.Tensor, logAT: torch.Tensor,
                       logB: torch.Tensor):
    """Kernel B14 (replaces ``_backpointers_kernel``): -> (bp [bk, nb]
    int32, dexit [K, nb] f32, ftab [nb] int32)."""
    _check_operands(steps2, (v_enter, logAT, logB))
    K, S = _check_tables(logAT, logB)
    bk, nb = steps2.shape
    _check("steps2", steps2, _I32, (bk, nb))
    _check("v_enter", v_enter, _F32, (K, nb))
    if steps2.device.type == "cpu":
        return dense_backpointers_plain(steps2, v_enter, logAT, logB)
    bp = torch.empty((bk, nb), dtype=_I32, device=steps2.device)
    dexit = torch.empty((K, nb), dtype=_F32, device=steps2.device)
    ftab = torch.empty((nb,), dtype=_I32, device=steps2.device)
    _kernels.launch("dense_backpointers", steps2, v_enter, logAT, logB, bp, dexit, ftab,
                    bk=bk, nb=nb, K=K, S=S)
    return bp, dexit, ftab


def dense_backtrace(bp: torch.Tensor, exits: torch.Tensor, K: int,
                    seg: int = 0) -> torch.Tensor:
    """Kernel B15 (replaces ``_backtrace_kernel``): -> path [bk, nb] int32
    state ids of a K-state model.  The kernel walks each lane in segments
    of ``seg`` steps joined by exact K-state maps (0: the kernel's own
    length, ``csrc/viterbi_dense.cu`` DBT_SEG, lengthened where a lane
    would need more segments than a block holds); the path is the one
    walk's whatever the length."""
    _check_operands(bp, (exits,))
    if not 1 <= K <= MAX_PACK_STATES:
        raise ValueError(f"dense_backtrace packs 3 bits a state: needs 1 <= K <= "
                         f"{MAX_PACK_STATES}, got {K}")
    if seg < 0:
        raise ValueError(f"seg must be 0 (the kernel's own) or positive, got {seg}")
    bk, nb = bp.shape
    _check("bp", bp, _I32, (bk, nb))
    _check("exits", exits, _I32, (nb,))
    if bp.device.type == "cpu":
        return dense_backtrace_plain(bp, exits)
    path = torch.empty((bk, nb), dtype=_I32, device=bp.device)
    _kernels.launch("dense_backtrace", bp, exits, path, bk=bk, nb=nb, K=K, seg=seg)
    return path


# ---------------------------------------------------------------------------
# Pass-level API (the "pallas" engine of viterbi_parallel.get_passes; same
# contracts as the "xla" twins, so the decode bodies swap engines freely).


def _tables(params: HmmParams):
    _require_support(params)
    logAT = params.log_A.T.to(_F32).contiguous()
    logB = params.log_B.to(_F32).contiguous()
    return logAT, logB


def lane_products(params: HmmParams, steps2: torch.Tensor) -> torch.Tensor:
    """Per-lane block products [nb, K, K] through B13."""
    logAT, logB = _tables(params)
    K = params.n_states
    out = dense_products(steps2.to(_I32).contiguous(), logAT, logB)
    return out.T.reshape(-1, K, K)


def pass_products(params: HmmParams, steps2: torch.Tensor, prev0=None):
    """Twin of viterbi_parallel._pass_products: (incl, offs, total)."""
    incl, offs = scan_block_products(lane_products(params, steps2))
    return incl, offs, incl[-1]


def pass_backpointers(params: HmmParams, v_enter: torch.Tensor, steps2: torch.Tensor,
                      prev0=None):
    """Twin of viterbi_parallel._pass_backpointers: (delta_exit [nb, K],
    F [nb, K] int32, blob) — the blob (the packed pointers and K) is
    consumed only by :func:`pass_backtrace`."""
    logAT, logB = _tables(params)
    bp, dexit, ftab = dense_backpointers(
        steps2.to(_I32).contiguous(), v_enter.T.to(_F32).contiguous(), logAT, logB)
    F = (ftab[:, None] >> _shifts(params.n_states, ftab.device)) & 7
    return dexit.T, F, (bp, params.n_states)


def pass_backtrace(blob, exits: torch.Tensor) -> torch.Tensor:
    """Twin of viterbi_parallel._pass_backtrace -> [bk * nb] path."""
    bp, K = blob
    return dense_backtrace(bp, exits.to(_I32).contiguous(), K).T.reshape(-1)


def viterbi_pallas(params: HmmParams, obs: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                   return_score: bool = True):
    """Exact Viterbi path through the dense kernels (one device): a thin
    front end over viterbi_parallel(engine="pallas")."""
    _require_support(params)
    from cpgisland_tpu_torch.ops.viterbi_parallel import viterbi_parallel

    return viterbi_parallel(params, obs, block_size=block_size, return_score=return_score,
                            engine="pallas")


def viterbi_pallas_batch(params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                         block_size: int = DEFAULT_BLOCK, return_score: bool = True):
    """Batched decode through the dense kernels (see viterbi_parallel_batch)."""
    _require_support(params)
    from cpgisland_tpu_torch.ops.viterbi_parallel import viterbi_parallel_batch

    return viterbi_parallel_batch(params, chunks, lengths, block_size=block_size,
                                  return_score=return_score, engine="pallas")
