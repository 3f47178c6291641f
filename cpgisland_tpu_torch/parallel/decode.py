"""Whole-record Viterbi decode on one device.

Counterpart of ``cpgisland_tpu/parallel/decode.py``, for one device (the JAX
package shards a record over a mesh; here the mesh has one member, so the
cross-device stitching is the identity and no collective runs).  Engine
resolution keeps the JAX package's rules, without its fault breaker.
"""

from __future__ import annotations

import numpy as np
import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import viterbi_pallas
from cpgisland_tpu_torch.ops.viterbi_parallel import (
    DEFAULT_BLOCK,
    _enter_vectors,
    _identity_logmat,
    _step_tables,
    _suffix_compositions,
    get_passes,
    nrm_maxplus_vec,
)


def resolve_engine(engine: str, params: HmmParams) -> str:
    """'auto' picks the reduced one-hot kernels when the model's emission
    structure supports them (the flagship 8-state model does), else the
    dense kernels when the model fits their 3-bit backpointer packing
    (K <= 8), else the plain "xla" twins.  'auto' picks the same names on
    the CPU, where every kernel wrapper runs its plain version.  An explicit
    engine is checked and honoured as named."""
    if engine == "auto":
        if family_partition.reduced_eligible(params):
            return "onehot"
        return "pallas" if viterbi_pallas.supports(params) else "xla"
    if engine not in ("xla", "pallas", "onehot"):
        raise ValueError(f"unknown engine {engine!r}; expected auto|xla|pallas|onehot")
    if engine == "pallas" and not viterbi_pallas.supports(params):
        raise ValueError(f"pallas engine needs n_states <= 8, got {params.n_states}")
    if engine == "onehot" and not family_partition.reduced_eligible(params):
        raise ValueError(
            "onehot engine needs a one-hot emission-support partition with "
            "2 states per symbol"
        )
    return engine


def _engine_for_record(eng: str, obs: np.ndarray, params: HmmParams) -> str:
    """Demote 'onehot' to a dense engine for records outside its exactness
    domain (first position has no real emission: the reduced chain has no
    entry group there) — the dense kernels when the 3-bit packing fits,
    else the "xla" twins."""
    if eng == "onehot" and (obs.shape[0] == 0 or int(obs[0]) >= params.n_symbols):
        return "pallas" if viterbi_pallas.supports(params) else "xla"
    return eng


def _prev_real_symbol(obs: np.ndarray, lo: int, n_symbols: int) -> int:
    """Last real symbol strictly before obs[lo] (host scan; O(PAD run))."""
    i = lo - 1
    while i >= 0 and int(obs[i]) >= n_symbols:
        i -= 1
    return int(obs[i]) if i >= 0 else 0


def _decode_body(params: HmmParams, obs_c: torch.Tensor, block_size: int,
                 engine: str, prev0: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-device decode body with one device: position 0
    is the init (its emission folds into v0) and becomes an identity step,
    so "state after step k" is the state at position k."""
    products, backpointers, backtrace = get_passes(engine)
    K = params.n_states
    pad_sym = params.n_symbols
    _, emit_ext = _step_tables(params)
    v0 = params.log_pi + emit_ext[obs_c[0].long()]
    steps = obs_c.clone()
    steps[0] = pad_sym
    nb = steps.shape[0] // block_size
    steps2 = steps.reshape(nb, block_size).T

    incl, _, _ = products(params, steps2, prev0)
    # Forward stitch over one device: the prefix of earlier devices is the
    # identity, so the entering vector is the normalized init vector.
    my_prefix = _identity_logmat(K, obs_c.device)
    v_dev = nrm_maxplus_vec(torch.amax(v0[:, None] + my_prefix, dim=0))
    v_enter = _enter_vectors(v_dev, incl)
    delta_blocks, F, bps = backpointers(params, v_enter, steps2, prev0)

    # Backward stitch: the exit state is the local argmax.
    Gsuf = _suffix_compositions(F)
    s_final = torch.argmax(delta_blocks[-1]).to(torch.int32)
    block_exits = torch.cat([Gsuf[1:, :][:, s_final.long()], s_final[None]])
    return backtrace(bps, block_exits)


def viterbi_sharded(
    params: HmmParams,
    obs,
    *,
    block_size: int = DEFAULT_BLOCK,
    engine: str = "auto",
    return_device: bool = False,
):
    """Decode one whole record on the params' device; returns the [T] int32
    path on the host, or as a tensor on the device with ``return_device``
    (for the device island caller).  The record pads with the PAD sentinel
    to a multiple of ``block_size`` (PAD steps are identity, so the result
    is exact).  The dense engines ignore ``prev0``."""
    obs = np.asarray(obs)
    T = obs.shape[0]
    eng = _engine_for_record(resolve_engine(engine, params), obs, params)
    S = params.n_symbols
    dev = params.device
    rem = (-T) % block_size
    arr = torch.from_numpy(np.ascontiguousarray(obs)).to(dev)
    obs_c = torch.clamp_max(arr.to(torch.int32), S)
    if rem:
        obs_c = torch.cat([obs_c, torch.full((rem,), S, dtype=torch.int32, device=dev)])
    prev0 = torch.tensor(int(obs[0]) if T and int(obs[0]) < S else 0, dtype=torch.int32, device=dev)
    path = _decode_body(params, obs_c, block_size, eng, prev0)[:T]
    return path if return_device else path.cpu().numpy()
