"""Island calling on the path's device (clean semantics), in plain PyTorch.

Counterpart of ``cpgisland_tpu/ops/islands_device.py``.  The host caller
(ops.islands) needs the whole decoded path on the host (4 B/symbol) and an
O(T) host pass; here the reduction runs where the path lies and only the
compact per-call integer counts cross to the host (a few MiB at most).

Mechanics, as in the JAX module: the path is cut into [n_blocks, W] time
blocks (one background sentinel past the end closes a run at the true end)
and reduced block by block, the run state threaded across blocks in the
carry (previous position's membership and C flag, cumulative C/G/CpG
totals, the open run's anchor, the emitted-call cursor).  Within a block:
membership, run boundaries and C/G/CpG events exactly as the host caller
computes them; per-run counts from block cumsums plus the carried bases;
the open run's anchor forward-filled from the latest opening (one scatter
by run number and one gather, where the JAX module takes a running max).
A run is emitted at its leaving position and
compacted into the [cap] output columns by one scatter at the carried
cursor; every other position writes to a dump slot of its own.
Temporaries are O(block), never O(T).

The float cuts on the device are conservative (a 1e-5 relative band around
each threshold); the host re-evaluates the survivors in float64 from the
exact int32 counts with the host caller's own formulas, so the emitted
calls and their gc/oe values are bit-identical to ops.islands.call_islands
(compat=False) and call_islands_obs.  int32 counts hold up to 2^31 symbols.

Reference scope: the island state machine, CpGIslandFinder.java:262-339.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.ops.islands import (
    C_STATE,
    G_STATE,
    N_ISLAND_STATES,
    IslandCalls,
    _empty_calls,
    counts_to_gc_oe,
)
from cpgisland_tpu_torch.utils import chunking

# Default maximum number of emitted calls per invocation.  Real genomes carry
# ~25-45k CpG islands in all; each slot costs 24 B of device output.
DEFAULT_CAP = 1 << 17

# Time-block width of the reduction: device temporaries are ~40 B x W
# (~160 MB at 4 Mi) whatever the record length.  Shorter inputs use one
# block rounded up to their size.
DEFAULT_BLOCK_W = 1 << 22

# Relative width of the conservative band around each float threshold:
# float32 gc/oe carry at most ~6e-7 relative rounding.
_F32_BAND = 1e-5

_I32 = torch.int32


class IslandCapOverflow(ValueError):
    """More island calls survived the filters than ``cap`` output slots.

    Carries the true count, so a caller can retry with a sufficient cap:
    the decoded path is still on the device, so the retry re-runs only the
    calling reduction, not the decode."""

    def __init__(self, n: int, cap: int):
        super().__init__(
            f"{n} island calls exceed cap={cap}; pass a larger cap "
            "(each slot costs 24 B of device output)"
        )
        self.n = n
        self.cap = cap


def _block_layout(T: int, block_w: int) -> tuple:
    """(n_blocks, W, pad): pad >= 1 so the final position is background and
    every run leaves (the clean-mode a-run-at-the-end-still-closes rule)."""
    W = 1 << 10
    while W < min(block_w, T + 1):
        W <<= 1
    nB = -(-(T + 1) // W)
    return nB, W, nB * W - T


def _ffill_at_openings(vals, opening, carries, idx0):
    """Each val's value at the latest opening at or before t within the
    block, else the carried value (a run opened in an earlier block).  The
    JAX module takes a running max over opening positions, which is the same
    for nondecreasing vals (indices and cumsums are); here one scatter of the
    openings' values by run number and one gather give it without a scan
    (a 1-D ``torch.cummax`` runs in one thread block on the card)."""
    W = opening.shape[0]
    run = torch.cumsum(opening, 0, dtype=_I32) - 1  # -1 before the block's first opening
    slot = torch.where(opening, run.long(), W + idx0.long())  # others: a dump slot each
    table = torch.empty((len(vals), 2 * W), dtype=_I32, device=opening.device)
    table[:, slot] = torch.stack(list(vals))
    got = table[:, torch.clamp_min(run, 0).long()]
    return [torch.where(run >= 0, g, c) for g, c in zip(got, carries)]


def _scan_calls(blocks, mask_fn, W: int, cap: int, min_len: Optional[int],
                gc_threshold: float, oe_threshold: float, device):
    """Blocked run accounting over an iterable of (path block, obs block)
    pairs of width W -> (columns [6, cap] int32, count [] int32), both on
    ``device``.  ``mask_fn`` maps a block pair to (in_mask, is_c, is_g, cgp):
    ``cgp`` is the "this position is a C" flag whose shift gates the CpG
    event (is_c for the 8-state labeling, raw obs == C for the
    observation-based caller, as in ops.islands)."""
    idx0 = torch.arange(W, dtype=_I32, device=device)
    zero = torch.zeros((), dtype=_I32, device=device)
    neg1 = torch.full((), -1, dtype=_I32, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    prev_in, prev_cgp = false, false
    c_base = g_base = cg_base = n = zero
    anchor = [neg1, neg1, neg1, neg1]  # opening index, pre-opening C/G/CpG cumsums
    # Columns [0, cap) hold the calls; [cap, cap + W) one dump slot per block
    # position, so the scatter's writes never collide (a single shared dump
    # slot serializes millions of same-address stores on the card).
    bufs = torch.zeros((6, cap + W), dtype=_I32, device=device)
    dump = cap + idx0.long()
    for b_i, (p, o) in enumerate(blocks):
        in_mask, is_c, is_g, cgp = mask_fn(p, o)
        gidx = b_i * W + idx0
        prev_in_v = torch.cat([prev_in[None], in_mask[:-1]])
        prev_cgp_v = torch.cat([prev_cgp[None], cgp[:-1]])
        # is_g implies in_mask: the host caller's in & prev_in & is_g & prev_c.
        cg_event = is_g & prev_in_v & prev_cgp_v
        opening = in_mask & ~prev_in_v
        # A run is emitted at its leaving position (first background
        # position after it); the padding makes every run leave.
        leaving = prev_in_v & ~in_mask

        cum_c = c_base + torch.cumsum(is_c, 0, dtype=_I32)
        cum_g = g_base + torch.cumsum(is_g, 0, dtype=_I32)
        cum_cg = cg_base + torch.cumsum(cg_event, 0, dtype=_I32)
        # The open run's anchor (opening index + pre-opening cumsums) at every
        # position; cg_event is False at openings.
        start_f, c0_f, g0_f, cg0_f = _ffill_at_openings(
            (gidx, cum_c - is_c.to(_I32), cum_g - is_g.to(_I32), cum_cg), opening, anchor, idx0)

        # At a leaving position t the run's last index is t - 1.
        length = gidx - start_f
        c_cnt = cum_c - c0_f
        g_cnt = cum_g - g0_f
        cg_cnt = cum_cg - cg0_f

        lengthf = length.float()
        both = (c_cnt > 0) & (g_cnt > 0)
        # c*g in float32: the int32 product of a ~92k-symbol GC-rich run
        # overflows.
        cgprod = c_cnt.float() * g_cnt.float()
        oe = torch.where(both, cg_cnt.float() * lengthf / torch.where(both, cgprod, 1.0), 0.0)
        if gc_threshold == 0.5:
            gc_pass = 2 * (c_cnt + g_cnt) > length  # integer-exact default cut
        else:
            gc = (c_cnt + g_cnt).float() / torch.clamp_min(lengthf, 1.0)
            gc_pass = gc > gc_threshold - _F32_BAND * abs(gc_threshold)
        keep = leaving & gc_pass & (oe > oe_threshold - _F32_BAND * abs(oe_threshold))
        if min_len is not None:
            keep &= length > min_len

        # Compact this block's survivors at the carried cursor; positions not
        # kept, and survivors past the cap, land in their dump slots.
        kcum = torch.cumsum(keep, 0, dtype=_I32)
        tgt = (n + kcum - 1).long()
        tgt = torch.where(keep & (tgt < cap), tgt, dump)
        bufs[:, tgt] = torch.stack([start_f, gidx - 1, length, c_cnt, g_cnt, cg_cnt])

        prev_in, prev_cgp = in_mask[-1], cgp[-1]
        c_base, g_base, cg_base = cum_c[-1], cum_g[-1], cum_cg[-1]
        anchor = [start_f[-1], c0_f[-1], g0_f[-1], cg0_f[-1]]
        n = n + kcum[-1]
    return bufs[:, :cap], n


def _blocks(x: torch.Tensor, nB: int, W: int, fill: int):
    """The [W] blocks of x, the last one padded with ``fill``."""
    for b in range(nB):
        piece = x[b * W : (b + 1) * W]
        if piece.shape[0] < W:
            piece = torch.cat([piece, piece.new_full((W - piece.shape[0],), fill)])
        yield piece


def _device_calls(path: torch.Tensor, cap: int, min_len: Optional[int], gc_threshold: float,
                  oe_threshold: float, block_w: int = DEFAULT_BLOCK_W):
    """8-state core: [T] path -> (columns, count) on the path's device.
    Base identity comes from the state ids (state 1 = C+, state 2 = G+)."""
    nB, W, _ = _block_layout(path.shape[0], block_w)

    def mask_fn(p, _o):
        p = p.to(_I32)
        in_mask = p < N_ISLAND_STATES
        is_c = in_mask & (p == C_STATE)
        is_g = in_mask & (p == G_STATE)
        return in_mask, is_c, is_g, is_c

    blocks = ((p, None) for p in _blocks(path, nB, W, N_ISLAND_STATES))
    return _scan_calls(blocks, mask_fn, W, cap, min_len, gc_threshold, oe_threshold,
                       path.device)


def _device_calls_obs(path: torch.Tensor, obs: torch.Tensor, island_states: tuple, cap: int,
                      min_len: Optional[int], gc_threshold: float, oe_threshold: float,
                      block_w: int = DEFAULT_BLOCK_W):
    """Generic core: membership from ``path`` in ``island_states``, base
    composition from the observations (symbol ids 0..3 = acgt)."""
    nB, W, _ = _block_layout(path.shape[0], block_w)
    background = max(island_states) + 1 if island_states else 0

    def mask_fn(p, o):
        p = p.to(_I32)
        o = o.to(_I32)
        in_mask = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
        for s in island_states:
            in_mask = in_mask | (p == s)
        obs_c = o == 1  # codec.C
        is_c = in_mask & obs_c
        is_g = in_mask & (o == 2)  # codec.G
        return in_mask, is_c, is_g, obs_c

    blocks = zip(_blocks(path, nB, W, background), _blocks(obs, nB, W, 0))
    return _scan_calls(blocks, mask_fn, W, cap, min_len, gc_threshold, oe_threshold,
                       path.device)


def _fetch_calls(cols: torch.Tensor, n: torch.Tensor, cap: int, offset: int,
                 gc_threshold: float, oe_threshold: float) -> IslandCalls:
    """Compact device columns -> exact host IslandCalls: one transfer of the
    int32 counts, then the host caller's float64 formulas and cuts."""
    host = torch.cat([n.reshape(1), cols.reshape(-1)]).cpu().numpy()
    n = int(host[0])
    if n > cap:
        raise IslandCapOverflow(n, cap)
    cols = host[1:].reshape(6, cap)[:, :n].astype(np.int64)
    starts, lasts, length, c_cnt, g_cnt, cg_cnt = cols
    gc, oe = counts_to_gc_oe(c_cnt, g_cnt, cg_cnt, length)
    keep = (gc > gc_threshold) & (oe > oe_threshold)
    return IslandCalls(
        beg=starts[keep] + offset + 1,
        end=lasts[keep] + offset + 1,
        length=length[keep],
        gc_content=np.asarray(gc[keep], np.float64),
        oe_ratio=np.asarray(oe[keep], np.float64),
    )


def call_islands_device(path, *, min_len: Optional[int] = None, cap: int = DEFAULT_CAP,
                        gc_threshold: float = 0.5, oe_threshold: float = 0.6,
                        offset: int = 0) -> IslandCalls:
    """Clean-mode island calls computed on the path's device (a tensor
    stays where it is; anything else goes to the CPU); returns host
    IslandCalls, bit-identical to ops.islands.call_islands(compat=False).
    Raises IslandCapOverflow, carrying the true count, if more than ``cap``
    calls survive the filters."""
    path = torch.as_tensor(path)
    if path.shape[0] == 0:
        return _empty_calls()
    cols, n = _device_calls(path, cap, min_len, float(gc_threshold), float(oe_threshold))
    return _fetch_calls(cols, n, cap, offset, gc_threshold, oe_threshold)


def call_islands_device_obs(path, obs, *, island_states, min_len: Optional[int] = None,
                            cap: int = DEFAULT_CAP, gc_threshold: float = 0.5,
                            oe_threshold: float = 0.6, offset: int = 0) -> IslandCalls:
    """Island calls for any set of island states on the path's device:
    membership from ``path``, composition from the aligned ``obs`` — the
    device counterpart of ops.islands.call_islands_obs, bit-identical to
    it."""
    path = torch.as_tensor(path)
    obs = chunking.upload(obs, path.device)
    if path.shape[0] != obs.shape[0]:
        raise ValueError(f"path {tuple(path.shape)} and obs {tuple(obs.shape)} differ")
    if path.shape[0] == 0:
        return _empty_calls()
    cols, n = _device_calls_obs(path, obs, tuple(sorted(island_states)), cap, min_len,
                                float(gc_threshold), float(oe_threshold))
    return _fetch_calls(cols, n, cap, offset, gc_threshold, oe_threshold)
