"""Forward-backward statistics: the E-step's output contract.

Counterpart of ``cpgisland_tpu/ops/forward_backward.py``, cut to the
:class:`SuffStats` container the chunked E-steps (``ops/fb_chunked.py``)
fill and the scoring entry :func:`sequence_loglik` (lane-parallel, through
the kernels of ``ops/loglik.py``).  The generic K-state engines (rescaled
and log numerics, posterior marginals) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from cpgisland_tpu_torch.ops.loglik import sequence_loglik  # noqa: F401  (the scoring entry)


@dataclasses.dataclass(frozen=True)
class SuffStats:
    """Expected-count sufficient statistics (the mapper output contract),
    tensors on the E-step's device.

    init:  [K]    expected count of starting in state i        (gamma_0)
    trans: [K, K] expected i->j transition counts              (sum_t xi_t)
    emit:  [K, S] expected state-i-emits-s counts              (sum_t gamma_t [o_t = s])
    loglik: []    total log-likelihood of the chunk(s)
    n_seqs: []    number of (non-empty) sequences accumulated
    """

    init: torch.Tensor
    trans: torch.Tensor
    emit: torch.Tensor
    loglik: torch.Tensor
    n_seqs: torch.Tensor

    @staticmethod
    def zeros(n_states: int, n_symbols: int, device="cpu") -> "SuffStats":
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
        return SuffStats(init=z(n_states), trans=z(n_states, n_states),
                         emit=z(n_states, n_symbols), loglik=z(),
                         n_seqs=torch.zeros((), dtype=torch.int32, device=device))

    def __add__(self, other: "SuffStats") -> "SuffStats":
        return SuffStats(*(getattr(self, f.name) + getattr(other, f.name)
                           for f in dataclasses.fields(self)))
