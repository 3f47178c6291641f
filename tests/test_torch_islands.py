"""Island calling of the PyTorch port vs the JAX package on seeded paths:
equal columns (exact — both are the same host NumPy arithmetic) and
byte-identical formatted lines, compat and clean."""

import numpy as np
import pytest

from cpgisland_tpu.ops import islands as JI
from cpgisland_tpu_torch.ops import islands as TI


def _sticky_path(rng, T):
    """State paths with island runs of realistic length: a sticky chain
    that mostly stays in its +/- block, with C/G-rich island states."""
    segs, t = [], 0
    while t < T:
        island = rng.random() < 0.4
        n = int(rng.integers(1, 400))
        p = np.array([0.15, 0.35, 0.35, 0.15]) if island else np.full(4, 0.25)
        segs.append(rng.choice(4, size=n, p=p) + (0 if island else 4))
        t += n
    return np.concatenate(segs)[:T].astype(np.int32)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("min_len", [None, 50])
def test_call_islands_matches_jax(rng, compat, min_len):
    n_calls = 0
    for trial in range(40):
        path = _sticky_path(rng, int(rng.integers(1, 5000)))
        kw = dict(chunk=trial % 3, chunk_size=4096, compat=compat, min_len=min_len)
        a, b = TI.call_islands(path, **kw), JI.call_islands(path, **kw)
        for col in ("beg", "end", "length", "gc_content", "oe_ratio"):
            assert np.array_equal(getattr(a, col), getattr(b, col)), col
        assert a.format_lines() == b.format_lines()
        n_calls += len(a)
    assert n_calls > 20  # the fixture really emits islands


def test_concatenate_and_names_match_jax(rng):
    paths = [_sticky_path(rng, 3000) for _ in range(3)]
    t = TI.IslandCalls.concatenate(
        [TI.call_islands(p, compat=False).with_names(f"r{i}") for i, p in enumerate(paths)]
        + [TI.call_islands(paths[0], compat=False)]
    )
    j = JI.IslandCalls.concatenate(
        [JI.call_islands(p, compat=False).with_names(f"r{i}") for i, p in enumerate(paths)]
        + [JI.call_islands(paths[0], compat=False)]
    )
    assert t.format_lines() == j.format_lines()
    assert TI.IslandCalls.concatenate([]).format_lines() == ""
    assert len(TI.call_islands(np.zeros(0, np.int32))) == 0


def test_counts_to_gc_oe_matches_jax(rng):
    c, g, cg = (rng.integers(0, 50, size=100) for _ in range(3))
    L = rng.integers(1, 200, size=100)
    for x, y in zip(TI.counts_to_gc_oe(c, g, cg, L), JI.counts_to_gc_oe(c, g, cg, L)):
        assert np.array_equal(x, y)
