"""Span threading of the port's posterior vs the JAX package's arithmetic.

``pipeline._thread_spans`` turns the spans' [K, K] transfer operators into
each span's entering-alpha and exiting-beta directions.  The JAX package
threads them in float32 (``cpgisland_tpu/pipeline.py``, the host threading
of ``posterior_file``): the init direction from float64 ``pi * B[:, first]``
cast to float32, then every product ``enters[-1] @ totals[s]`` and every
normalization in float32, the exits from a float32 uniform vector.  The
expected values below are a copy of those lines, fed the port's own totals
of a 3-span record, so enters and exits must match bit for bit, on the
reduced engine (the flagship) and on the dense one (two_state).
"""

import numpy as np
import pytest
import torch

from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.parallel import posterior as post
from cpgisland_tpu_torch.parallel.decode import _prev_real_symbol

SPAN = 3000


def _reference_threading(params, symbols, totals):
    """The JAX package's host threading, line for line."""
    pi = np.exp(np.asarray(params.log_pi.numpy(), np.float64))
    B = np.exp(np.asarray(params.log_B.numpy(), np.float64))
    v = pi * B[:, int(symbols[0])] if int(symbols[0]) < params.n_symbols else pi
    enters = [(v / v.sum()).astype(np.float32)]
    for s in range(len(totals) - 1):
        v = enters[-1] @ totals[s]
        enters.append((v / v.sum()).astype(np.float32))
    exits = [None] * len(totals)
    e = np.full(params.n_states, 1.0 / params.n_states, np.float32)
    for s in range(len(totals) - 2, -1, -1):
        e = totals[s + 1] @ e
        e = (e / e.sum()).astype(np.float32)
        exits[s] = e
    return enters, exits


def _record(seed, n, lead_pad=0):
    rng = np.random.default_rng(seed)
    s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    for a in range(500, n - 700, 2400):
        s[a : a + 600] = rng.choice(4, size=600, p=[0.15, 0.35, 0.35, 0.15])
    s[:lead_pad] = 4
    return s


def _span_totals(params, symbols, engine):
    totals = []
    for lo in range(0, symbols.size, SPAN):
        piece = symbols[lo : lo + SPAN]
        prev = 0 if lo == 0 else _prev_real_symbol(symbols, lo, params.n_symbols)
        totals.append(post.transfer_total_sharded(params, piece, engine=engine, first=lo == 0,
                                                  prev_sym=prev))
    return totals


@pytest.fixture
def short_lanes(monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 512)


@pytest.mark.parametrize("model, engine", [("durbin8", "onehot"), ("two_state", "pallas")])
@pytest.mark.parametrize("lead_pad", [0, 3])
def test_thread_spans_equals_reference_threading(short_lanes, model, engine, lead_pad):
    params = presets.durbin_cpg8() if model == "durbin8" else presets.two_state_cpg()
    symbols = _record(7, 3 * SPAN - 400, lead_pad)
    totals = _span_totals(params, symbols, engine)
    assert len(totals) == 3 and all(t.dtype == np.float32 for t in totals)
    enters, exits = TPL._thread_spans(params, int(symbols[0]), totals)
    want_e, want_x = _reference_threading(params, symbols, totals)
    assert exits[-1] is None and want_x[-1] is None
    for got, want in zip(enters, want_e):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for got, want in zip(exits[:-1], want_x[:-1]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_threaded_posterior_reads_the_threaded_directions(short_lanes):
    """The span-threaded posterior_file still agrees with the one-pass
    posterior of the same record (the threading is exact up to rounding)."""
    params = presets.durbin_cpg8()
    symbols = _record(3, 3 * SPAN - 400)
    mask = post.island_mask(params, (0, 1, 2, 3))
    one, _ = fb_seq.seq_posterior(params, torch.from_numpy(symbols), symbols.size, mask)
    totals = _span_totals(params, symbols, "onehot")
    enters, exits = TPL._thread_spans(params, int(symbols[0]), totals)
    parts = []
    for s, lo in enumerate(range(0, symbols.size, SPAN)):
        piece = symbols[lo : lo + SPAN]
        prev = 0 if lo == 0 else _prev_real_symbol(symbols, lo, 4)
        conf, _ = post.posterior_sharded(params, piece, (0, 1, 2, 3), engine="onehot",
                                         enter_dir=None if s == 0 else enters[s],
                                         exit_dir=exits[s], first=s == 0, prev_sym=prev)
        parts.append(conf)
    np.testing.assert_allclose(np.concatenate(parts), one.numpy(), rtol=0, atol=2e-5)
