"""Whole-record posterior (soft) decoding on one device.

Counterpart of ``cpgisland_tpu/parallel/posterior.py``, for one device:
per-position island confidence P(position in island | whole record) and
the max-posterior-marginal path, through ``ops.fb_seq`` on the reduced
one-hot engine (kernels B7 and B4; B7, B9 and B10 or B11 on the split arm,
``fused=False``; B8 with ``one_pass``) or the dense one (B17, B16 and B18,
or B19 for the confidence alone).  The JAX package shards a
record over a mesh; here the mesh has one member, so the cross-device
exchange is the identity.  Span threading across calls (``enter_dir`` /
``exit_dir``) is driven by ``pipeline.posterior_file``.
``posterior_sharded_stacked`` runs M reduced members over one record
through the stacked kernels (B21 and B24, or B22 and B23 on the split
arm), for ``family.compare``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_pallas, fb_seq
from cpgisland_tpu_torch.ops.prepared import PreparedSeq, prepare_seq
from cpgisland_tpu_torch.train.backends import ONEHOT_MAX_STATES
from cpgisland_tpu_torch.utils import chunking

_XLA_NOT_PORTED = (
    "the generic XLA lane posterior (any K, log numerics) is not ported yet "
    "(ROADMAP A2)"
)


def resolve_fb_engine(engine: str, params: HmmParams) -> str:
    """'auto' picks the reduced one-hot kernels for a reduced-eligible model
    with K <= 32 (the flagship is one), else the dense kernels for K <= 8
    (``fb_pallas.supports``), as the JAX router does on its TPU.  'pallas'
    is honoured wherever the dense kernels fit; 'xla', and 'auto' for a
    model neither engine takes, raise NotImplementedError (ROADMAP A2)."""
    eligible = (family_partition.reduced_eligible(params)
                and params.n_states <= ONEHOT_MAX_STATES)
    if engine == "auto":
        if eligible:
            return "onehot"
        if fb_pallas.supports(params):
            return "pallas"
        raise NotImplementedError(
            f"{params.n_states} states over {params.n_symbols} symbols: outside the "
            f"reduced engine's domain and the dense kernels' (K <= {fb_pallas.MAX_STATES}, "
            f"S <= {fb_pallas.MAX_SYMBOLS}); {_XLA_NOT_PORTED}"
        )
    if engine == "xla":
        raise NotImplementedError(_XLA_NOT_PORTED)
    if engine == "pallas":
        if not fb_pallas.supports(params):
            raise ValueError(
                f"pallas FB kernels need n_states <= {fb_pallas.MAX_STATES} and "
                f"n_symbols <= {fb_pallas.MAX_SYMBOLS}, got {params.n_states} / "
                f"{params.n_symbols}"
            )
        return engine
    if engine != "onehot":
        raise ValueError(f"unknown engine {engine!r}; expected auto|xla|pallas|onehot")
    if not eligible:
        raise ValueError(
            "onehot FB kernels need a one-hot emission-support partition with 2 "
            f"states per symbol and at most {ONEHOT_MAX_STATES} states"
        )
    return engine


def island_mask(params: HmmParams, island_states) -> np.ndarray:
    mask = np.zeros(params.n_states, np.float32)
    mask[list(island_states)] = 1.0
    return mask


def _prev_sym_arg(engine: str, first: bool, prev_sym) -> Optional[int]:
    """The reduced kernels condition a continuation span's entry group on
    the symbol before it; forgetting it would silently mis-condition the
    chain, so a onehot continuation span without ``prev_sym`` raises.  The
    dense engine reads no prev symbol (None)."""
    if engine != "onehot":
        return None
    if prev_sym is None:
        if not first:
            raise ValueError(
                "onehot continuation spans (first=False) need prev_sym — the "
                "symbol immediately before this span"
            )
        return None
    return int(prev_sym)


def place_record_span(params: HmmParams, piece, *, pad_to: Optional[int] = None) -> torch.Tensor:
    """Upload one span's symbols (uint8) to the params' device ONCE for both
    span sweeps (or, in ``family.compare``, for every member of an order).
    ``pad_to`` pads with PAD (``n_symbols``) to that many symbols; the
    consumers take the real length separately."""
    piece = np.ascontiguousarray(piece)
    if pad_to is not None and pad_to > piece.shape[0]:
        piece = np.concatenate([piece, np.full(pad_to - piece.shape[0], params.n_symbols,
                                               piece.dtype)])
    return chunking.upload(piece, params.device)


def prepare_record_span(params: HmmParams, placed: torch.Tensor, length: int, *,
                        engine: str = "auto", first: bool = True,
                        prev_sym: Optional[int] = None,
                        lane_T: Optional[int] = None) -> PreparedSeq:
    """One span's symbol-only prep for the resolved engine (the lane layout,
    plus the pair stream on the reduced engine), shared by the
    transfer-total sweep and the posterior sweep."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    return prepare_seq(params.n_symbols, placed, int(length),
                       lane_T=lane_T or fb_seq.pick_lane_T(placed.shape[0]), first=first,
                       prev_sym=ps, onehot=eng == "onehot")


def posterior_sharded(params: HmmParams, obs, island_states, *, engine: str = "auto",
                      lane_T: Optional[int] = None, enter_dir=None, exit_dir=None,
                      first: bool = True, want_path: bool = False, placed=None,
                      prev_sym: Optional[int] = None,
                      prepared: Optional[PreparedSeq] = None, return_device: bool = False,
                      fused: Optional[bool] = None, one_pass: Optional[bool] = None):
    """Island confidence (and optionally the MPM path) of one sequence on
    the params' device.  Returns host arrays (conf [T] f32, path [T] int8 —
    state ids, a quarter of an int32 download — or None), or the same as
    tensors left on the device with ``return_device`` (for the device
    island caller).

    ``placed`` (from :func:`place_record_span`) reuses an uploaded span and
    ``prepared`` (from :func:`prepare_record_span`) its prep, whose lane
    geometry then wins.  ``enter_dir`` / ``exit_dir`` ([K] directions)
    thread span-boundary messages; continuation spans (``first=False``)
    on the reduced engine need ``prev_sym``.  On the reduced engine the
    fused two-pass arm runs (B7, B4); ``fused=False`` the split arm (B7,
    B9, then B11 for the confidence alone or B10 with ``want_path``);
    ``one_pass=True`` the one-pass arm (B8), whatever ``fused`` says.
    ``fused=None`` means True and ``one_pass=None`` False, the JAX
    package's shipped defaults (the port has no tuner table, ROADMAP A14);
    the dense engine ignores both."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    arr = placed if placed is not None else place_record_span(params, obs)
    T = int(obs.shape[0])  # a placed span may be padded past the record
    conf, path = fb_seq.seq_posterior(
        params, arr, T, island_mask(params, island_states),
        enter_dir=enter_dir, exit_dir=exit_dir, first=first, want_path=want_path,
        lane_T=lane_T, prev_sym=ps, prepared=prepared, engine=eng, one_pass=bool(one_pass),
        fused=fused is None or bool(fused),
    )
    conf, path = conf[:T], (path[:T].to(torch.int8) if want_path else None)
    if return_device:
        return conf, path
    return conf.cpu().numpy(), (path.cpu().numpy() if want_path else None)


def transfer_total_sharded(params: HmmParams, obs, *, engine: str = "auto",
                           first: bool = True, placed=None, prev_sym: Optional[int] = None,
                           prepared: Optional[PreparedSeq] = None) -> np.ndarray:
    """One span's normalized [K, K] probability-space transfer operator on
    the host (sweep A of span threading).  ``placed`` / ``prepared`` as in
    :func:`posterior_sharded`; reduced continuation spans need
    ``prev_sym``."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    arr = placed if placed is not None else place_record_span(params, obs)
    total = fb_seq.seq_transfer_total(params, arr, int(obs.shape[0]), first=first,
                                      prev_sym=ps, prepared=prepared, engine=eng)
    return total.cpu().numpy()


def posterior_sharded_stacked(params_list, obs, island_states_list, *, want_path: bool = False,
                              lane_T: Optional[int] = None, placed=None,
                              prepared: Optional[PreparedSeq] = None,
                              fused: Optional[bool] = None):
    """Island confidence (and optionally MPM paths) of M reduced members of
    one alphabet over ONE record, through the stacked kernels (B21, B24;
    with ``fused=False`` B21, B22 and B23, ``None`` meaning True): host
    arrays (conf [M, T] f32, path [M, T] int8 or None).  Member m's rows
    equal ``posterior_sharded(params_list[m], ..., engine="onehot",
    fused=fused)`` on the same ``placed`` input and geometry bit for bit;
    callers group
    members whose engine resolves to "onehot" (``family.stacked``).
    ``placed``: the record's one upload, shared with the scoring pass and
    the sequential arm."""
    params_list = tuple(params_list)
    for p in params_list:
        resolve_fb_engine("onehot", p)
    arr = placed if placed is not None else place_record_span(params_list[0], obs)
    masks = [island_mask(p, s) for p, s in zip(params_list, island_states_list)]
    T = int(obs.shape[0])
    conf, path = fb_seq.seq_posterior_stacked(params_list, arr, T, masks, want_path=want_path,
                                              lane_T=lane_T, prepared=prepared,
                                              fused=fused is None or bool(fused))
    return (conf[:, :T].cpu().numpy(),
            path[:, :T].to(torch.int8).cpu().numpy() if want_path else None)
