"""Stacked multi-model dispatch: same-order reduced members in ONE launch set.

Counterpart of ``cpgisland_tpu/family/stacked.py``.  ``family.compare``
evaluates several members over the SAME symbol stream; members that share
a stream order (hence an alphabet) and whose forward-backward engine
resolves to the reduced "onehot" one group into one stacked dispatch
(``parallel.posterior.posterior_sharded_stacked`` -> kernels B21 and B24).
Each member's confidence and path equal its own sequential record unit on
the same placed stream bit for bit, so grouping changes the launches,
never the results.  The JAX package re-runs a failed stacked unit on the
sequential arm under its supervisor; the port has no resilience layer yet
(ROADMAP A12), so a stacked failure raises.
"""

from __future__ import annotations


def stack_groups(members, fb_engines, enabled: bool = True) -> dict:
    """order -> member-index list for same-order members whose RESOLVED FB
    engine is "onehot".  A group needs at least 2 members: a singleton
    gains nothing from stacking.  ``fb_engines`` aligns with ``members``
    (None for members that run no posterior)."""
    if not enabled:
        return {}
    by_order: dict = {}
    for i, m in enumerate(members):
        if m.is_null or fb_engines[i] != "onehot":
            continue
        by_order.setdefault(m.order, []).append(i)
    return {o: ix for o, ix in by_order.items() if len(ix) >= 2}


def stacked_posterior_records(members, symbols, *, placed=None, prepared=None, mesh=None):
    """ONE stacked dispatch for a group over one record: per-member (conf
    [M, T], path [M, T]) host arrays.  ``symbols``: the group's stream (of
    its order); the members' params lie on the device they run on;
    ``mesh``: as in ``posterior_sharded_stacked``."""
    from cpgisland_tpu_torch.parallel.posterior import posterior_sharded_stacked

    return posterior_sharded_stacked(
        [m.params for m in members], symbols, [m.island_states for m in members],
        want_path=True, placed=placed, prepared=prepared, mesh=mesh,
    )
