"""Whole-record posterior (soft) decoding on one device.

Counterpart of ``cpgisland_tpu/parallel/posterior.py``, for one device
and the reduced one-hot engine: per-position island confidence
P(position in island | whole record) and the max-posterior-marginal path,
through ``ops.fb_seq`` (kernels B7 and B4).  The JAX package shards a
record over a mesh; here the mesh has one member, so the cross-device
exchange is the identity.  Span threading across calls (``enter_dir`` /
``exit_dir``) is driven by ``pipeline.posterior_file``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops.prepared import PreparedSeq, prepare_seq
from cpgisland_tpu_torch.train.backends import ONEHOT_MAX_STATES

_NOT_PORTED = (
    "only the reduced one-hot posterior engine is ported; the dense "
    "forward-backward engine (kernels B16-B20, ROADMAP A10) and the XLA lane "
    "path (A2) are not ported yet"
)


def resolve_fb_engine(engine: str, params: HmmParams) -> str:
    """'auto' picks the reduced one-hot kernels for a reduced-eligible model
    with K <= 32 (the flagship is one); every other engine or model raises
    (not ported)."""
    eligible = (family_partition.reduced_eligible(params)
                and params.n_states <= ONEHOT_MAX_STATES)
    if engine == "auto":
        if eligible:
            return "onehot"
        raise NotImplementedError(_NOT_PORTED)
    if engine in ("xla", "pallas"):
        raise NotImplementedError(_NOT_PORTED)
    if engine != "onehot":
        raise ValueError(f"unknown engine {engine!r}; expected auto|onehot")
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
    chain, so a onehot continuation span without ``prev_sym`` raises."""
    if prev_sym is None:
        if not first and engine == "onehot":
            raise ValueError(
                "onehot continuation spans (first=False) need prev_sym — the "
                "symbol immediately before this span"
            )
        return None
    return int(prev_sym)


def place_record_span(params: HmmParams, piece) -> torch.Tensor:
    """Upload one span's symbols (uint8) to the params' device ONCE for both
    span sweeps."""
    return torch.from_numpy(np.ascontiguousarray(piece)).to(params.device)


def prepare_record_span(params: HmmParams, placed: torch.Tensor, length: int, *,
                        engine: str = "auto", first: bool = True,
                        prev_sym: Optional[int] = None,
                        lane_T: Optional[int] = None) -> PreparedSeq:
    """One span's symbol-only prep (lane layout + pair stream), shared by the
    transfer-total sweep and the posterior sweep."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    return prepare_seq(params.n_symbols, placed, int(length),
                       lane_T=lane_T or fb_seq.pick_lane_T(placed.shape[0]), first=first,
                       prev_sym=ps)


def posterior_sharded(params: HmmParams, obs, island_states, *, engine: str = "auto",
                      lane_T: Optional[int] = None, enter_dir=None, exit_dir=None,
                      first: bool = True, want_path: bool = False, placed=None,
                      prev_sym: Optional[int] = None,
                      prepared: Optional[PreparedSeq] = None):
    """Island confidence (and optionally the MPM path) of one sequence on
    the params' device.  Returns host arrays (conf [T] f32, path [T] int8 —
    state ids, a quarter of an int32 download — or None).

    ``placed`` (from :func:`place_record_span`) reuses an uploaded span and
    ``prepared`` (from :func:`prepare_record_span`) its prep, whose lane
    geometry then wins.  ``enter_dir`` / ``exit_dir`` ([K] directions)
    thread span-boundary messages; continuation spans (``first=False``)
    need ``prev_sym``.  The fused two-pass arm runs (the JAX package's
    default); its split arm (B9-B12) and one-pass arm (B8) are not ported."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    arr = placed if placed is not None else place_record_span(params, obs)
    conf, path = fb_seq.seq_posterior(
        params, arr, int(obs.shape[0]), island_mask(params, island_states),
        enter_dir=enter_dir, exit_dir=exit_dir, first=first, want_path=want_path,
        lane_T=lane_T, prev_sym=ps, prepared=prepared,
    )
    return conf.cpu().numpy(), (path.to(torch.int8).cpu().numpy() if want_path else None)


def transfer_total_sharded(params: HmmParams, obs, *, engine: str = "auto",
                           first: bool = True, placed=None, prev_sym: Optional[int] = None,
                           prepared: Optional[PreparedSeq] = None) -> np.ndarray:
    """One span's normalized [K, K] probability-space transfer operator on
    the host (sweep A of span threading).  ``placed`` / ``prepared`` as in
    :func:`posterior_sharded`; continuation spans need ``prev_sym``."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    arr = placed if placed is not None else place_record_span(params, obs)
    total = fb_seq.seq_transfer_total(params, arr, int(obs.shape[0]), first=first,
                                      prev_sym=ps, prepared=prepared)
    return total.cpu().numpy()
