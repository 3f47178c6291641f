"""Named model presets (counterpart of ``cpgisland_tpu/models/presets.py``).

``durbin_cpg8`` is the flagship: the 8-state CpG+/CpG- model the reference
hardcodes as its Baum-Welch initialization (CpGIslandFinder.java:155-173).
State ids: 0..3 = A+ C+ G+ T+ (island), 4..7 = A- C- G- T- (background);
emissions are one-hot (state X+- emits x).

``two_state_cpg`` is a minimal island/background model whose states do not
encode bases: it decodes through the dense engines, and islands are called
with ``island_states=(0,)`` (membership from the path, composition from the
observations).

``dinuc_cpg`` (order 2, over the pair alphabet) and ``null_background``
(one state, scoring only) complete the built-in family of
``family.members``; ``random_hmm`` draws test models.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.models.hmm import HmmParams

HIDDEN_STATE_NAMES = ("A+", "C+", "G+", "T+", "A-", "C-", "G-", "T-")
EMITTED_STATE_NAMES = ("a", "c", "g", "t")

_DURBIN_PI = np.array([0.05, 0.05, 0.05, 0.05, 0.2, 0.2, 0.2, 0.2])
_LEAK = 0.0025
_DURBIN_PLUS = np.array(
    [
        [0.170, 0.274, 0.426, 0.120],
        [0.170, 0.358, 0.274, 0.188],
        [0.161, 0.329, 0.375, 0.125],
        [0.079, 0.345, 0.384, 0.182],
    ]
)
_DURBIN_MINUS = np.array(
    [
        [0.300, 0.205, 0.275, 0.210],
        [0.393, 0.137, 0.088, 0.372],
        [0.248, 0.246, 0.288, 0.208],
        [0.177, 0.239, 0.282, 0.292],
    ]
)


def durbin_cpg8(device="cpu") -> HmmParams:
    """The 8-state A+-C+-G+-T+- CpG model (reference init, java:155-173)."""
    A = np.full((8, 8), _LEAK)
    A[:4, :4] = _DURBIN_PLUS
    A[4:, 4:] = _DURBIN_MINUS
    B = np.zeros((8, 4))
    B[np.arange(8), np.arange(8) % 4] = 1.0  # one-hot: X+- emits x
    return HmmParams.from_probs(_DURBIN_PI, A, B, device=device)


def two_state_cpg(p_stay_island: float = 0.999, p_stay_bg: float = 0.9995,
                  device="cpu") -> HmmParams:
    """A minimal 2-state island/background model.  State 0 = island
    (GC-rich emissions), state 1 = background (AT-leaning)."""
    pi = np.array([0.1, 0.9])
    A = np.array(
        [
            [p_stay_island, 1.0 - p_stay_island],
            [1.0 - p_stay_bg, p_stay_bg],
        ]
    )
    B = np.array(
        [
            [0.15, 0.35, 0.35, 0.15],  # island: C/G enriched
            [0.30, 0.20, 0.20, 0.30],  # background: A/T enriched
        ]
    )
    return HmmParams.from_probs(pi, A, B, device=device)


#: Island (first-half) state ids of the dinucleotide model, the pair-alphabet
#: analogue of the flagship's states 0..3.
DINUC_ISLAND_STATES = tuple(range(16))

#: Pair-symbol index of the CpG dinucleotide ("CG" = prev C, cur G) in the
#: recoded alphabet (codec.recode_pairs).
CPG_PAIR = 1 * 4 + 2


def dinuc_cpg(device="cpu") -> HmmParams:
    """Order-2 (dinucleotide-emission) CpG model over the PAIR alphabet
    (``codec.recode_pairs``: pair = prev * 4 + cur).  State ``sign * 16 +
    pair`` emits exactly its own pair, so the emission support partitions
    the 32 states into 16 blocks of 2 and the model runs on the reduced
    engines like the flagship.  Transitions chain pairs: (a, b, s) -> (b, c,
    s') with the Durbin table ``P_s[b, c]`` within a sign and the flagship's
    0.0025 leak across signs; transitions to non-chaining pairs are
    structural zeros.  Every complete-path probability equals the
    flagship's times 1/4 (the prior split of the opening pair state), so
    log-likelihoods differ by exactly -log 4 and posteriors agree."""
    A = np.zeros((32, 32))
    for sign, tab in ((0, _DURBIN_PLUS), (1, _DURBIN_MINUS)):
        for a in range(4):
            for b in range(4):
                row = sign * 16 + a * 4 + b
                for c in range(4):
                    A[row, sign * 16 + b * 4 + c] = tab[b, c]
                    A[row, (1 - sign) * 16 + b * 4 + c] = _LEAK
    pi = np.concatenate([np.full(16, 0.2 / 16), np.full(16, 0.8 / 16)])
    B = np.zeros((32, 16))
    B[np.arange(32), np.arange(32) % 16] = 1.0
    return HmmParams.from_probs(pi, A, B, device=device)


def _background_stationary() -> np.ndarray:
    """Stationary distribution of the (leak-free, row-renormalized) Durbin
    background chain: the expected base composition outside islands."""
    P = _DURBIN_MINUS / _DURBIN_MINUS.sum(axis=1, keepdims=True)
    w, v = np.linalg.eig(P.T)
    i = int(np.argmin(np.abs(w - 1.0)))
    pi = np.abs(np.real(v[:, i]))
    return pi / pi.sum()


def null_background(n_symbols: int = 4, device="cpu") -> HmmParams:
    """Single-state background scoring model, the log-odds denominator of
    ``family.compare``: self-transition 1, emitting the stationary
    composition of the Durbin background chain (``n_symbols=4``) or the
    stationary dinucleotide joint ``pi(a) * P-(b|a)`` over the pair alphabet
    (``n_symbols=16``).  It has no island states."""
    statv = _background_stationary()
    if n_symbols == 4:
        B = statv[None, :]
    elif n_symbols == 16:
        P = _DURBIN_MINUS / _DURBIN_MINUS.sum(axis=1, keepdims=True)
        B = (statv[:, None] * P).reshape(1, 16)
    else:
        raise ValueError(
            f"null_background supports the base (4) and pair (16) alphabets, got "
            f"n_symbols={n_symbols}"
        )
    return HmmParams.from_probs(np.ones(1), np.ones((1, 1)), B / B.sum(), device=device)


def random_hmm(generator: torch.Generator, n_states: int, n_symbols: int, *,
               partition: Optional[int] = None, device="cpu") -> HmmParams:
    """Random row-stochastic model (Dirichlet(1) rows drawn from
    ``generator``).  ``partition``: instead of random emissions, one-hot
    emissions with exactly ``partition`` states per symbol (state k emits
    ``k % n_symbols``; needs ``n_states == partition * n_symbols``);
    ``partition=2`` models run on the reduced engines.  The JAX package
    draws from ``jax.random``, so the two give different models from one
    seed: tests carry a model across as arrays."""
    def dirichlet(*shape):
        x = -torch.log(torch.rand(*shape, generator=generator, dtype=torch.float64))
        return x / x.sum(dim=-1, keepdim=True)

    pi = dirichlet(n_states)
    A = dirichlet(n_states, n_states)
    if partition is not None:
        if n_states != partition * n_symbols:
            raise ValueError(
                f"partition={partition} needs n_states == partition * n_symbols, got "
                f"{n_states} != {partition} * {n_symbols}"
            )
        B = np.zeros((n_states, n_symbols))
        B[np.arange(n_states), np.arange(n_states) % n_symbols] = 1.0
    else:
        B = dirichlet(n_states, n_symbols).numpy()
    return HmmParams.from_probs(pi.numpy(), A.numpy(), B, device=device)
