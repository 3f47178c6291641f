"""Model-family layer: emission-support partition analysis, named family
members, and the multi-model posterior comparison (counterpart of
``cpgisland_tpu/family``).

- :mod:`.partition`: ``partition_of(params)``, the eligibility oracle of the
  reduced engines;
- :mod:`.members`: named models (flagship, two-state, the order-2
  dinucleotide model over the pair alphabet, null backgrounds);
- :mod:`.compare`: N members over one stream: log-odds, islands, winner
  track;
- :mod:`.stacked`: same-order reduced members in ONE stacked launch set,
  bit-identical to the sequential arm.
"""

from cpgisland_tpu_torch.family import stacked  # noqa: F401  (public submodule)
from cpgisland_tpu_torch.family.compare import (
    DEFAULT_WINNER_THRESHOLD,
    MemberResult,
    RecordComparison,
    compare_record,
    resolve_baseline,
    winner_calls,
    winner_track,
)
from cpgisland_tpu_torch.family.members import (
    MEMBER_NAMES,
    Member,
    builtin_member,
    default_members,
    member_from_params,
    members_from_names,
)
from cpgisland_tpu_torch.family.partition import (
    REDUCED_GROUP,
    EmissionPartition,
    partition_concrete,
    partition_of,
    reduced_eligible,
    reduced_stats_eligible,
)

__all__ = [
    "REDUCED_GROUP",
    "EmissionPartition",
    "partition_concrete",
    "partition_of",
    "reduced_eligible",
    "reduced_stats_eligible",
    "Member",
    "MEMBER_NAMES",
    "builtin_member",
    "member_from_params",
    "members_from_names",
    "default_members",
    "MemberResult",
    "RecordComparison",
    "compare_record",
    "resolve_baseline",
    "winner_calls",
    "winner_track",
    "DEFAULT_WINNER_THRESHOLD",
]
