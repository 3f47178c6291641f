"""Named model-family members: comparable model objects.

Counterpart of ``cpgisland_tpu/family/members.py``.  A :class:`Member`
bundles the params, which states count as "island" (the island callers'
and posterior masks' input) and the observation ORDER (1 = the base
alphabet the codec emits; 2 = the pair alphabet of
:func:`cpgisland_tpu_torch.utils.codec.recode_pairs`).  Members run through
the ordinary engine routers.

The built-in registry is the comparison workload's cast:

- ``durbin8``: the flagship 8-state model (reduced engines);
- ``two_state``: the minimal island/background model (dense engines);
- ``dinuc_cpg``: the order-2 dinucleotide model over the pair alphabet
  (reduced engines: 16 blocks of 2);
- ``null`` / ``null16``: single-state background scoring models (base /
  pair alphabet), the log-odds denominators.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cpgisland_tpu_torch.family import partition as partition_mod
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.utils import codec


@dataclasses.dataclass(frozen=True)
class Member:
    """One model of a family.  ``island_states`` may be empty: a pure
    scoring model (the null members) has no island track and never wins a
    winner-track position.  ``order=2`` members consume the pair-recoded
    stream; :meth:`encode` is the one place that decision lives."""

    name: str
    params: HmmParams
    island_states: tuple = ()
    order: int = 1
    description: str = ""

    def __post_init__(self):
        if self.order not in (1, 2):
            raise ValueError(f"member order must be 1 or 2, got {self.order}")
        # A mismatched alphabet would score the wrong stream (a pair model fed
        # base symbols dies on its structural zeros): a construction error.
        want_S = 4 if self.order == 1 else 16
        if self.params.n_symbols != want_S:
            raise ValueError(
                f"member {self.name!r}: order-{self.order} members consume the {want_S}-symbol "
                f"codec stream, but the model has n_symbols={self.params.n_symbols}"
            )
        K = self.params.n_states
        bad = [s for s in self.island_states if not 0 <= int(s) < K]
        if bad:
            raise ValueError(f"member {self.name!r}: island states {bad} outside 0..{K - 1}")

    def encode(self, symbols: np.ndarray, prev: Optional[int] = None) -> np.ndarray:
        """The member's observation stream for a base-alphabet record: the
        record itself for order 1, its pair recode for order 2 (``prev``:
        the base before the record).  Order-2 members need a PAD-free base
        stream (the codec's default 'skip' policy)."""
        if self.order == 1:
            return np.asarray(symbols)
        s = np.asarray(symbols)
        if s.size and int(s.max()) >= codec.N_SYMBOLS:
            raise ValueError(
                f"order-2 member {self.name!r} needs a PAD-free base stream (contains "
                "symbols >= 4): encode with the default invalid_symbols='skip' policy"
            )
        return codec.recode_pairs(s, prev=prev)

    @property
    def partition(self):
        """The member's emission-support partition (``partition_of``), None
        for non-partitioned members."""
        return partition_mod.partition_of(self.params)

    @property
    def is_null(self) -> bool:
        return not self.island_states


def _builtin_builders():
    return {
        "durbin8": lambda: Member(
            "durbin8", presets.durbin_cpg8(), tuple(range(4)), 1,
            "flagship 8-state reference CpG model (reduced engines)",
        ),
        "two_state": lambda: Member(
            "two_state", presets.two_state_cpg(), (0,), 1,
            "minimal island/background model (dense engines)",
        ),
        "dinuc_cpg": lambda: Member(
            "dinuc_cpg", presets.dinuc_cpg(), presets.DINUC_ISLAND_STATES, 2,
            "order-2 dinucleotide CpG model over the pair alphabet "
            "(reduced decode engines; 16 blocks of 2)",
        ),
        "null": lambda: Member(
            "null", presets.null_background(4), (), 1,
            "single-state background scoring model (base alphabet)",
        ),
        "null16": lambda: Member(
            "null16", presets.null_background(16), (), 2,
            "single-state background scoring model (pair alphabet)",
        ),
    }


MEMBER_NAMES = ("durbin8", "two_state", "dinuc_cpg", "null", "null16")


def builtin_member(name: str) -> Member:
    """One built-in member by name (ValueError on an unknown name)."""
    builders = _builtin_builders()
    if name not in builders:
        raise ValueError(f"unknown family member {name!r}; built-ins: {', '.join(MEMBER_NAMES)}")
    return builders[name]()


def member_from_params(name: str, params: HmmParams, *, island_states=None,
                       order: Optional[int] = None) -> Member:
    """Wrap loaded or trained params as a member.  ``island_states=None``
    takes the reference labeling (the first n_symbols states) for 2M-state
    models and the empty set otherwise; ``order=None`` infers the order
    from the alphabet (4 symbols: base, 16: pair; any other raises)."""
    if order is None:
        if params.n_symbols == 4:
            order = 1
        elif params.n_symbols == 16:
            order = 2
        else:
            raise ValueError(
                f"member {name!r}: cannot infer stream order for n_symbols="
                f"{params.n_symbols} (codec streams are 4-symbol base or 16-symbol pair)"
            )
    if island_states is None:
        island_states = (tuple(range(params.n_symbols))
                         if params.n_states == 2 * params.n_symbols else ())
    return Member(name, params, tuple(sorted(island_states)), order)


def members_from_names(names) -> list:
    """Built-in members by name (the CLI's --models form), checking
    uniqueness."""
    seen = set()
    out = []
    for n in names:
        if n in seen:
            raise ValueError(f"duplicate member name {n!r}")
        seen.add(n)
        out.append(builtin_member(n))
    return out


def default_members() -> list:
    """The default 3-model comparison cast: flagship vs minimal vs null."""
    return members_from_names(("durbin8", "two_state", "null"))
