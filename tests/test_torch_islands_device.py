"""The port's device island caller (ops.islands_device, plain PyTorch on the
path's device) against the port's host caller and the JAX package's
``call_islands_device`` / ``call_islands_device_obs``, on the CPU.

The device reduction compacts exact int32 counts and the host re-evaluates
gc/oe and the thresholds in float64 with the host caller's formulas, so
every comparison here is BIT FOR BIT, as in tests/test_islands_device.py.
"""

import io

import numpy as np
import pytest
import torch

from cpgisland_tpu.ops import islands_device as JD
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.ops import islands as H
from cpgisland_tpu_torch.ops import islands_device as D

FIELDS = ("beg", "end", "length", "gc_content", "oe_ratio")


def _assert_same(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def _torch_calls(path, block_w=D.DEFAULT_BLOCK_W, cap=D.DEFAULT_CAP, min_len=None,
                 gc_threshold=0.5, oe_threshold=0.6):
    """The torch caller at a chosen block width (as the JAX package's tests
    drive ``_device_calls`` directly)."""
    cols, n = D._device_calls(torch.from_numpy(path), cap, min_len, gc_threshold,
                              oe_threshold, block_w)
    return D._fetch_calls(cols, n, cap, 0, gc_threshold, oe_threshold)


def _both(path, **kw):
    """Torch device caller vs the host caller and the JAX device caller."""
    block_w = kw.pop("block_w", None)
    if block_w is None:
        got = D.call_islands_device(torch.from_numpy(path), **kw)
    else:
        got = _torch_calls(path, block_w=block_w, **kw)
    host_kw = {k: v for k, v in kw.items() if k in ("min_len", "gc_threshold", "oe_threshold")}
    _assert_same(got, H.call_islands(path, compat=False, **host_kw))
    _assert_same(got, JD.call_islands_device(path, **kw))
    return got


def _islandy(rng, n_runs, bg_max, isl_lo, isl_hi):
    parts = []
    for _ in range(n_runs):
        parts.append(rng.integers(4, 8, size=rng.integers(1, bg_max)))
        parts.append(rng.choice([1, 2, 0], p=[0.45, 0.45, 0.1], size=rng.integers(isl_lo, isl_hi)))
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("T", [1, 2, 7, 1000, 4097])
def test_random_paths(rng, T):
    _both(rng.integers(0, 8, size=T).astype(np.int32))


@pytest.mark.parametrize("block_w", [1024, D.DEFAULT_BLOCK_W])
def test_island_dense_paths(rng, block_w):
    """CpG-dense paths; at block_w = 1024 runs and C|G pairs straddle block
    boundaries and some runs span several whole blocks."""
    path = _islandy(rng, 40, 700, 1, 3000)
    assert len(_both(path, block_w=block_w)) > 10


def test_cpg_pair_across_a_block_boundary():
    W = 1024
    p = np.full(3 * W, 4, np.int32)
    p[W - 300 : W + 300] = 1
    p[W + 300 : W + 600] = 2
    p[W - 1], p[W] = 1, 2
    _both(p, block_w=W)


@pytest.mark.parametrize("path", [
    [1, 2, 1, 2, 4, 4],
    [4, 4, 1, 2, 1, 2],  # a run at the end: clean mode emits it
    [2, 1, 2, 1],
    [4, 5, 6, 7],
    [1, 4] * 50,
])
def test_edge_runs(path):
    _both(np.array(path, np.int32))


def test_empty_path():
    assert len(D.call_islands_device(torch.zeros(0, dtype=torch.int32))) == 0
    assert len(D.call_islands_device_obs(np.zeros(0, np.int32), np.zeros(0, np.uint8),
                                         island_states=(0,))) == 0


def test_min_len_and_offset(rng):
    path = np.concatenate([rng.choice([1, 2], size=300), [4], rng.choice([1, 2], size=150),
                           [4]]).astype(np.int32)
    base = _both(path, min_len=200)
    assert len(base) == 1
    shifted = D.call_islands_device(torch.from_numpy(path), min_len=200, offset=1000)
    np.testing.assert_array_equal(shifted.beg, base.beg + 1000)
    np.testing.assert_array_equal(shifted.end, base.end + 1000)


def _island_path(c, g, cg, length):
    """One island run with exact (C, G, CpG, length) counts (as in
    tests/test_islands_device.py)."""
    pad = length - c - g - 1
    body = [2] * (g - cg) + [1, 2] * cg + [0] + [1] * (c - cg) + [0] * pad
    return np.array([4] + body + [4], np.int32)


@pytest.mark.parametrize("c,g,cg,length,kept", [
    (2971, 1693, 629, 4798, True),  # f64 oe just above 0.6; f32 lands on it
    (25, 30, 5, 90, False),  # an exact tie: dropped
    (25, 30, 4, 90, False),
    (25, 30, 6, 90, True),
])
def test_thresholds_near_the_boundary(c, g, cg, length, kept):
    assert len(_both(_island_path(c, g, cg, length))) == (1 if kept else 0)


@pytest.mark.parametrize("thr", [0.55, 0.549999, 0.550001])
def test_nondefault_gc_threshold(thr):
    _both(_island_path(6, 5, 3, 20), gc_threshold=thr)


def test_long_island_no_int32_overflow():
    """A 120k-symbol GC-rich run: c * g > 2^31 must not wrap."""
    path = np.concatenate([[4], np.tile([1, 2], 60_000), [4]]).astype(np.int32)
    assert len(_both(path)) == 1


@pytest.mark.parametrize("block_w", [1024, D.DEFAULT_BLOCK_W])
def test_observation_based_caller(rng, block_w):
    """Membership from the path (island_states), composition from the
    observations (PAD symbols included), runs longer than a block."""
    T = 9000
    path = (rng.random(T) < 0.02).astype(np.int32)  # 1 = background
    path[:200] = 1
    path[5800:6000] = 1
    path[3000:3400] = 2  # an id outside the island set
    obs = rng.choice(5, p=[0.15, 0.33, 0.33, 0.15, 0.04], size=T).astype(np.uint8)
    cols, n = D._device_calls_obs(torch.from_numpy(path), torch.from_numpy(obs), (0,),
                                  D.DEFAULT_CAP, 10, 0.5, 0.6, block_w)
    got = D._fetch_calls(cols, n, D.DEFAULT_CAP, 0, 0.5, 0.6)
    _assert_same(got, H.call_islands_obs(path, obs, island_states=(0,), min_len=10))
    _assert_same(got, JD.call_islands_device_obs(path, obs, island_states=(0,), min_len=10))
    assert len(got) > 0


def test_cap_overflow_carries_the_true_count():
    path = np.tile([1, 2, 4], 100).astype(np.int32)  # 100 two-long islands
    with pytest.raises(D.IslandCapOverflow, match="cap") as ei:
        D.call_islands_device(torch.from_numpy(path), cap=4)
    assert ei.value.n == 100 and ei.value.cap == 4
    _both(path, cap=ei.value.n)


def test_retry_grows_the_cap_and_respects_the_ceiling(monkeypatch):
    path = torch.from_numpy(np.tile([1, 2, 4], 100).astype(np.int32))
    box = [4]
    calls = TPL._device_calls_retry(D.call_islands_device, path, cap_box=box)
    assert len(calls) == 100 and box[0] == 128
    monkeypatch.setattr(TPL, "ISLAND_CAP_CEILING", 16)
    box = [4]
    with pytest.raises(D.IslandCapOverflow):
        TPL._device_calls_retry(D.call_islands_device, path, cap_box=box)
    assert box[0] == 4


def test_decode_file_regrows_the_cap_without_decoding_again(tmp_path, monkeypatch):
    """An island-saturated file through decode_file with a tiny island_cap:
    the cap grows once and is kept for the rest of the file (the big record
    overflows, the later batch does not), the decode runs once per record,
    and the calls equal the host engine's."""
    monkeypatch.setattr(TPL, "SMALL_RECORD_MAX", 4000)
    fa = tmp_path / "sat.fa"
    with open(fa, "w") as f:
        for name, reps in (("big", 40), ("s1", 3), ("s2", 2)):
            f.write(f">{name}\n" + ("cg" * 30 + "ta" * 30) * reps + "\n")
    params = TP.durbin_cpg8()
    host = io.StringIO()
    TPL.decode_file(str(fa), params, islands_out=host, compat=False, island_engine="host",
                    device="cpu")
    decodes, overflows = [], []
    orig_sharded, orig_grow = TPL.viterbi_sharded, TPL._grow_cap_or_raise
    monkeypatch.setattr(TPL, "viterbi_sharded",
                        lambda *a, **k: decodes.append(1) or orig_sharded(*a, **k))
    monkeypatch.setattr(TPL, "_grow_cap_or_raise",
                        lambda e, box: overflows.append(e.n) or orig_grow(e, box))
    dev = io.StringIO()
    res = TPL.decode_file(str(fa), params, islands_out=dev, compat=False,
                          island_engine="device", island_cap=8, device="cpu")
    assert dev.getvalue() == host.getvalue() and len(res.calls) > 8
    assert len(decodes) == 1 and len(overflows) == 1
