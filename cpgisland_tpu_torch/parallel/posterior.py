"""Whole-record posterior (soft) decoding, sequence-parallel over a mesh.

Counterpart of ``cpgisland_tpu/parallel/posterior.py``: per-position
island confidence P(position in island | whole record) and the
max-posterior-marginal path, through ``ops.fb_seq`` on the reduced one-hot
engine (kernels B7 and B4; B7, B9 and B10 or B11 on the split arm,
``fused=False``; B8 with ``one_pass``) or the dense one (B17, B16 and B18,
or B19 for the confidence alone), or through the generic lane path of
``parallel.fb_sharded`` ("xla": any K).  A record splits along time over
a mesh's shards (``parallel.mesh``; default one entry on the params'
device), with the boundary-message exchange between them
(``fb_sharded.device_boundary_messages``); a one-entry mesh runs the
one-device passes with no exchange.  Span threading across calls
(``enter_dir`` / ``exit_dir``) is driven by ``pipeline.posterior_file``.
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
from cpgisland_tpu_torch.parallel import fb_sharded
from cpgisland_tpu_torch.parallel.fb_sharded import DEFAULT_BLOCK
from cpgisland_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    Mesh,
    check_mesh,
    fetch_sharded_prefix,
    make_mesh,
)
from cpgisland_tpu_torch.train.backends import ONEHOT_MAX_STATES
from cpgisland_tpu_torch.utils import chunking


def resolve_fb_engine(engine: str, params: HmmParams) -> str:
    """'auto' picks the reduced one-hot kernels for a reduced-eligible model
    with K <= 32 (the flagship is one), else the dense kernels for K <= 8
    (``fb_pallas.supports``), else "xla", the generic lane path, as the
    JAX router does on its TPU.  An explicit engine is honoured where it
    fits the model; "xla" fits every model."""
    eligible = (family_partition.reduced_eligible(params)
                and params.n_states <= ONEHOT_MAX_STATES)
    if engine == "auto":
        if eligible:
            return "onehot"
        return "pallas" if fb_pallas.supports(params) else "xla"
    if engine == "xla":
        return engine
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


def _mesh_for(params: HmmParams, mesh) -> Mesh:
    """The call's mesh: the given one, else one entry on the params' device."""
    return check_mesh(mesh) or make_mesh(axis=SEQ_AXIS, device=params.device)


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


def place_record_span(params: HmmParams, piece, *, pad_to: Optional[int] = None,
                      mesh: Optional[Mesh] = None, block_size: int = DEFAULT_BLOCK):
    """Upload one span's symbols (uint8) ONCE for both span sweeps (or, in
    ``family.compare``, for every member of an order).  ``pad_to`` pads
    with PAD (``n_symbols``) to that many symbols; the consumers take the
    real length separately.  On a one-entry mesh (the default) the span is
    one tensor on the params' device; on a larger mesh a tuple of shards,
    one per entry on its device, the span padded to a multiple of D x
    ``block_size`` (``fb_sharded.shard_sequence``)."""
    piece = np.ascontiguousarray(piece)
    if pad_to is not None and pad_to > piece.shape[0]:
        piece = np.concatenate([piece, np.full(pad_to - piece.shape[0], params.n_symbols,
                                               piece.dtype)])
    mesh = _mesh_for(params, mesh)
    if mesh.size == 1:
        return chunking.upload(piece, mesh.first)
    obs_p, _ = fb_sharded.shard_sequence(piece, mesh.size, block_size, params.n_symbols)
    return fb_sharded.place_shards(mesh, obs_p)


def _span_shards(params: HmmParams, obs, placed, mesh: Mesh, block_size: int):
    """(shards, real-symbol counts) of one span on ``mesh`` for the sharded
    passes: ``placed`` as :func:`place_record_span` left it (a one-entry
    mesh's tensor is padded to a block multiple on its device), else
    uploaded here; ``obs`` supplies the real length."""
    T = int(obs.shape[0])
    if placed is None:
        placed = place_record_span(params, obs, mesh=mesh, block_size=block_size)
    if isinstance(placed, torch.Tensor):
        pad = (-placed.shape[0]) % block_size or (block_size if placed.shape[0] == 0 else 0)
        if pad:
            placed = torch.cat([placed, placed.new_full((pad,), params.n_symbols)])
        return [placed], [T]
    L = int(placed[0].shape[0])
    return list(placed), [int(n) for n in np.clip(T - np.arange(len(placed)) * L, 0, L)]


def prepare_record_span(params: HmmParams, placed, length: int, *,
                        engine: str = "auto", first: bool = True,
                        prev_sym: Optional[int] = None,
                        lane_T: Optional[int] = None,
                        mesh: Optional[Mesh] = None) -> Optional[PreparedSeq]:
    """One span's symbol-only prep for the resolved engine (the lane layout,
    plus the pair stream on the reduced engine), shared by the
    transfer-total sweep and the posterior sweep.  None where the span has
    no prepared form: the lane path ("xla") and a mesh of more than one
    entry (its shards are prepared inline, as in the JAX package)."""
    eng = resolve_fb_engine(engine, params)
    if eng == "xla" or _mesh_for(params, mesh).size > 1:
        return None
    ps = _prev_sym_arg(eng, first, prev_sym)
    return prepare_seq(params.n_symbols, placed, int(length),
                       lane_T=lane_T or fb_seq.pick_lane_T(placed.shape[0]), first=first,
                       prev_sym=ps, onehot=eng == "onehot")


def posterior_sharded(params: HmmParams, obs, island_states, *, engine: str = "auto",
                      mesh: Optional[Mesh] = None, block_size: int = DEFAULT_BLOCK,
                      lane_T: Optional[int] = None, enter_dir=None, exit_dir=None,
                      first: bool = True, want_path: bool = False, placed=None,
                      prev_sym: Optional[int] = None,
                      prepared: Optional[PreparedSeq] = None, return_device: bool = False,
                      fused: Optional[bool] = None, one_pass: Optional[bool] = None):
    """Island confidence (and optionally the MPM path) of one sequence,
    split along time over ``mesh`` (default: one entry on the params'
    device).  Returns host arrays (conf [T] f32, path [T] int8 — state
    ids, a quarter of an int32 download — or None), or the same as tensors
    on the mesh's first device with ``return_device`` (for the device
    island caller).

    ``placed`` (from :func:`place_record_span` on the same mesh) reuses an
    uploaded span and ``prepared`` (from :func:`prepare_record_span`, a
    one-entry mesh's kernel engines) its prep, whose lane geometry then
    wins.  ``enter_dir`` / ``exit_dir`` ([K] directions) thread
    span-boundary messages; continuation spans (``first=False``) on the
    reduced engine need ``prev_sym``.  ``engine="xla"`` runs the lane path
    in lanes of ``block_size`` steps.  On the reduced engine the fused
    two-pass arm runs (B7, B4); ``fused=False`` the split arm (B7, B9,
    then B11 for the confidence alone or B10 with ``want_path``);
    ``one_pass=True`` the one-pass arm (B8), whatever ``fused`` says.
    ``fused=None`` means True and ``one_pass=None`` False, the JAX
    package's shipped defaults (the port has no tuner table, ROADMAP A14);
    the dense engine and the lane path ignore both."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    mesh = _mesh_for(params, mesh)
    T = int(obs.shape[0])  # a placed span may be padded past the record
    mask = island_mask(params, island_states)
    fused = fused is None or bool(fused)
    if mesh.size == 1 and eng != "xla":
        arr = placed if placed is not None else place_record_span(params, obs, mesh=mesh)
        conf, path = fb_seq.seq_posterior(
            params, arr, T, mask, enter_dir=enter_dir, exit_dir=exit_dir, first=first,
            want_path=want_path, lane_T=lane_T, prev_sym=ps, prepared=prepared, engine=eng,
            one_pass=bool(one_pass), fused=fused,
        )
        conf, path = conf[:T], (path[:T].to(torch.int8) if want_path else None)
        if return_device:
            return conf, path
        return conf.cpu().numpy(), (path.cpu().numpy() if want_path else None)
    shards, lengths = _span_shards(params, obs, placed, mesh, block_size)
    if eng == "xla":
        out = fb_sharded.lane_posterior(params, shards, lengths, mask, block_size=block_size,
                                        first=first, enter_dir=enter_dir, exit_dir=exit_dir,
                                        want_path=want_path)
    else:
        lt = lane_T or fb_seq.pick_lane_T(shards[0].shape[0])
        out = fb_seq.seq_posterior_sharded(
            params, shards, lengths, mask, lane_T=lt, engine=eng, enter_dir=enter_dir,
            exit_dir=exit_dir, first=first, want_path=want_path, prev_sym=ps,
            one_pass=bool(one_pass), fused=fused)
    conf = fetch_sharded_prefix([c for c, _ in out], T, return_device)
    path = (fetch_sharded_prefix([p.to(torch.int8) for _, p in out], T, return_device)
            if want_path else None)
    return conf, path


def transfer_total_sharded(params: HmmParams, obs, *, engine: str = "auto",
                           mesh: Optional[Mesh] = None, block_size: int = DEFAULT_BLOCK,
                           first: bool = True, placed=None, prev_sym: Optional[int] = None,
                           prepared: Optional[PreparedSeq] = None) -> np.ndarray:
    """One span's normalized [K, K] probability-space transfer operator on
    the host (sweep A of span threading).  ``placed`` / ``prepared`` as in
    :func:`posterior_sharded`; reduced continuation spans need
    ``prev_sym``.  A one-entry mesh on the kernel engines runs the products
    kernel (B7 or B17); the lane path ("xla") and a larger mesh compose
    every shard's pass A products in mesh order, as the JAX package's
    ``_transfer_total_fn`` does."""
    eng = resolve_fb_engine(engine, params)
    ps = _prev_sym_arg(eng, first, prev_sym)
    mesh = _mesh_for(params, mesh)
    if mesh.size == 1 and eng != "xla":
        arr = placed if placed is not None else place_record_span(params, obs, mesh=mesh)
        total = fb_seq.seq_transfer_total(params, arr, int(obs.shape[0]), first=first,
                                          prev_sym=ps, prepared=prepared, engine=eng)
        return total.cpu().numpy()
    shards, lengths = _span_shards(params, obs, placed, mesh, block_size)
    return fb_sharded.lane_transfer_total(params, shards, lengths, block_size=block_size,
                                          first=first).cpu().numpy()


def posterior_sharded_stacked(params_list, obs, island_states_list, *, want_path: bool = False,
                              lane_T: Optional[int] = None, placed=None,
                              prepared: Optional[PreparedSeq] = None,
                              fused: Optional[bool] = None, mesh: Optional[Mesh] = None,
                              block_size: int = DEFAULT_BLOCK):
    """Island confidence (and optionally MPM paths) of M reduced members of
    one alphabet over ONE record, through the stacked kernels (B21, B24;
    with ``fused=False`` B21, B22 and B23, ``None`` meaning True): host
    arrays (conf [M, T] f32, path [M, T] int8 or None).  Member m's rows
    equal ``posterior_sharded(params_list[m], ..., engine="onehot",
    fused=fused)`` on the same ``placed`` input and geometry bit for bit;
    callers group members whose engine resolves to "onehot"
    (``family.stacked``).  ``placed``: the record's one upload, shared
    with the scoring pass and the sequential arm.  Over a mesh of more than
    one entry every shard runs the stacked kernels on its lanes, with one
    exchange per member (``fb_seq.seq_posterior_stacked_sharded``)."""
    params_list = tuple(params_list)
    for p in params_list:
        resolve_fb_engine("onehot", p)
    T = int(obs.shape[0])
    m_ = _mesh_for(params_list[0], mesh)
    masks = [island_mask(p, s) for p, s in zip(params_list, island_states_list)]
    fused = fused is None or bool(fused)
    if m_.size > 1:
        shards, lengths = _span_shards(params_list[0], obs, placed, m_, block_size)
        out = fb_seq.seq_posterior_stacked_sharded(
            params_list, shards, lengths, masks,
            lane_T=lane_T or fb_seq.pick_lane_T(shards[0].shape[0]), want_path=want_path,
            fused=fused)
        conf = np.concatenate([c.cpu().numpy() for c, _ in out], axis=1)[:, :T]
        path = (np.concatenate([q.to(torch.int8).cpu().numpy() for _, q in out], axis=1)[:, :T]
                if want_path else None)
        return conf, path
    arr = placed if placed is not None else place_record_span(params_list[0], obs, mesh=m_)
    conf, path = fb_seq.seq_posterior_stacked(params_list, arr, T, masks, want_path=want_path,
                                              lane_T=lane_T, prepared=prepared, fused=fused)
    return (conf[:, :T].cpu().numpy(),
            path[:, :T].to(torch.int8).cpu().numpy() if want_path else None)
