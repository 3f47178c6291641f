"""Emission-support partition analysis — the eligibility oracle for the
reduced (one-hot) engines.  Counterpart of ``cpgisland_tpu/family/
partition.py``, cut to what the engine routers and ``family.members``
consult.

Whenever the per-symbol supports {s : B[s, o] > 0} partition the states into
disjoint blocks, the Viterbi score vector at time t is LOG_ZERO outside
block(o_t), so the K-state recurrence is exactly a block-to-block recurrence
whose per-step matrix is the [G, G] slice of A between block(o_{t-1}) and
block(o_t).  The reduced kernels implement one-hot states in uniform blocks
of :data:`REDUCED_GROUP`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from cpgisland_tpu_torch.models.hmm import LOG_ZERO, HmmParams

# Block size the reduced kernels implement (2 states per chain step, 2-bit
# backpointers).  ops.viterbi_onehot.GROUP re-exports this value.
REDUCED_GROUP = 2


@dataclasses.dataclass(frozen=True)
class EmissionPartition:
    """Block structure of a partitioned emission matrix: ``blocks[b]`` is the
    ascending tuple of state ids in block b."""

    n_states: int
    n_symbols: int
    blocks: tuple
    block_of_symbol: np.ndarray  # [S] int32
    block_of_state: np.ndarray  # [K] int32
    onehot: bool  # every state supports exactly ONE symbol
    uniform: Optional[int]  # the common block size, or None if ragged

    @property
    def reduced(self) -> bool:
        """Inside the reduced engines' domain: one-hot states in uniform
        blocks of exactly REDUCED_GROUP states."""
        return self.onehot and self.uniform == REDUCED_GROUP


def partition_concrete(params: HmmParams) -> Union[EmissionPartition, bool]:
    """The :class:`EmissionPartition` when the emission supports partition
    the states, else ``False``."""
    logB = params.log_B.detach().cpu().numpy()
    if logB.ndim != 2:
        return False
    K, S = logB.shape
    # Entries must be real probabilities or structural zeros.
    if not np.all(np.isfinite(logB) | (logB <= LOG_ZERO / 2)):
        return False
    supp = logB > LOG_ZERO / 2  # [K, S]
    if not supp.any(axis=0).all():
        return False  # a symbol no state emits
    if not supp.any(axis=1).all():
        return False  # a silent state belongs to no block
    # Per-symbol supports must be pairwise EQUAL or DISJOINT.
    sig_to_block: dict = {}
    block_states: list = []
    block_of_symbol = np.empty(S, np.int32)
    for o in range(S):
        key = tuple(np.nonzero(supp[:, o])[0].tolist())
        b = sig_to_block.get(key)
        if b is None:
            b = len(block_states)
            sig_to_block[key] = b
            block_states.append(key)
        block_of_symbol[o] = b
    block_of_state = np.full(K, -1, np.int32)
    for b, states in enumerate(block_states):
        for k in states:
            if block_of_state[k] >= 0:
                return False  # overlapping, non-equal supports
            block_of_state[k] = b
    sizes = {len(b) for b in block_states}
    return EmissionPartition(
        n_states=K,
        n_symbols=S,
        blocks=tuple(block_states),
        block_of_symbol=block_of_symbol,
        block_of_state=block_of_state,
        onehot=bool(np.all(supp.sum(axis=1) == 1)),
        uniform=sizes.pop() if len(sizes) == 1 else None,
    )


def partition_of(params: HmmParams) -> Optional[EmissionPartition]:
    """The partition, or None when the emission supports do not partition
    the states."""
    p = partition_concrete(params)
    return p if isinstance(p, EmissionPartition) else None


def reduced_eligible(params: HmmParams) -> bool:
    """The emission supports partition the states into uniform one-hot
    blocks of REDUCED_GROUP states — the reduced engines' domain."""
    p = partition_concrete(params)
    return bool(p is not False and p.reduced)


def reduced_stats_eligible(params: HmmParams) -> bool:
    """Eligibility for the reduced-stream chunked-EM stats: reduced_eligible
    AND a power-of-two n_symbols (the z-normalized stats path of the JAX
    package lowers only for power-of-two alphabets; the port keeps its
    domain)."""
    S = params.n_symbols
    return reduced_eligible(params) and S & (S - 1) == 0
