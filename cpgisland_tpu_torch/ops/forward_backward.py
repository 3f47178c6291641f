"""Forward-backward statistics: the E-step's output contract.

Counterpart of ``cpgisland_tpu/ops/forward_backward.py``, cut to the
:class:`SuffStats` container the reduced chunked E-step
(``ops/fb_chunked.py``) fills.  The generic K-state engines (rescaled and
log numerics, posterior marginals) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


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
