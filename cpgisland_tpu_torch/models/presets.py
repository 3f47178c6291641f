"""Named model presets (counterpart of ``cpgisland_tpu/models/presets.py``).

``durbin_cpg8`` is the flagship: the 8-state CpG+/CpG- model the reference
hardcodes as its Baum-Welch initialization (CpGIslandFinder.java:155-173).
State ids: 0..3 = A+ C+ G+ T+ (island), 4..7 = A- C- G- T- (background);
emissions are one-hot (state X+- emits x).

``two_state_cpg`` is a minimal island/background model whose states do not
encode bases: it decodes through the dense engines, and islands are called
with ``island_states=(0,)`` (membership from the path, composition from the
observations).
"""

from __future__ import annotations

import numpy as np

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
