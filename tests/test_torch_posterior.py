"""The posterior slice of the PyTorch port vs the JAX package, on the CPU.

On the CPU the port's kernel wrappers (B7 ``oh_prod``, B4 ``oh_fwdbwd``)
take their plain PyTorch versions, and the JAX package's onehot route runs
its XLA twins (``_xla_products_prob``, ``_xla_fwdbwd_onehot``).  Both lay
out the same ``lane_T``; the JAX package pads the lane count to its
128-lane tile, the port does not (empty lanes are identity products), so
the boundary scans combine in different trees.  Held: transfer directions
within rtol 1e-5, confidence within atol 2e-5 (the JAX package's own
posterior parity pin), MPM paths equal except where the two group
gammas are within 1e-5 of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu.ops import islands as JIS
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu.utils.npystream import NpyStreamWriter as JWriter
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import islands as TIS
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH
from cpgisland_tpu_torch.parallel import posterior as TPO
from cpgisland_tpu_torch.utils.npystream import NpyStreamWriter as TWriter

MASK8 = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
LANE_T, T_TILE = 512, 256


def _both():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _genome(rng, n):
    """Background at GC 0.41 with CpG depleted (3 of 4 CG -> CA) and a
    planted GC-rich stretch every ~3 kb."""
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295]).astype(np.uint8)
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    s[cg[rng.random(cg.size) < 0.75] + 1] = 0
    for a in range(300, n - 700, 3000):
        s[a : a + 600] = rng.choice(4, size=600, p=[0.15, 0.35, 0.35, 0.15])
    return s


def _path_equal_except_ties(jp_path, t_path, ah, bh, tol=1e-5):
    """MPM paths equal except where the group's two gammas are within
    ``tol`` (either state is then a true argmax at f32 rounding)."""
    diff = np.flatnonzero(np.asarray(jp_path) != np.asarray(t_path))
    assert diff.size == 0 or np.all(np.abs(ah[diff] - bh[diff]) <= tol), diff[:10]


@pytest.mark.parametrize("NL", [1, 33, 128])
@pytest.mark.parametrize("Tp", [1, 7, 4099])
def test_oh_prod_plain_matches_xla_twin(rng, Tp, NL):
    """B7's plain version vs ``_xla_products_prob`` with PAD runs: the
    directions (each lane's 2x2 normalized to sum 1) within rtol 1e-5, with
    an absolute floor of 2e-6 for the small entries: XLA:CPU contracts the
    products into FMAs and PyTorch rounds each one, and the last-bit
    differences of the renormalized chain accumulate over 4099 steps."""
    jp, tp = _both()
    pair = rng.integers(0, 16, size=(Tp, NL)).astype(np.int32)
    pad = rng.random((Tp, NL)) < 0.1
    pair[pad] = 16 + rng.integers(0, 4, size=int(pad.sum()))
    if Tp > 100:
        pair[Tp // 2 : Tp // 2 + 60, 0] = 17  # a PAD run
    want = jax.jit(JFB._xla_products_prob)(JFB.prob_pair_table(jp, JOH._groups(jp)),
                                           jnp.asarray(pair))
    got = TFB.products_reduced(tp, torch.from_numpy(pair))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-6)


def test_conf_from_reduced_matches_jax(rng):
    jp, tp = _both()
    Tp, NL = 50, 9
    al = rng.random((Tp, 2, NL)).astype(np.float32)
    be = rng.random((Tp, 2, NL)).astype(np.float32)
    be[3, :, 2] = 0.0  # an all-zero gamma
    esym = rng.integers(0, 4, size=(Tp, NL)).astype(np.int32)
    lens = rng.integers(0, Tp + 1, size=(1, NL)).astype(np.int32)
    mask = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.float32)
    want = JFB.conf_from_reduced(jnp.asarray(al), jnp.asarray(be), jnp.asarray(esym),
                                 jnp.asarray(lens), jnp.asarray(mask), JOH._groups(jp))
    got = TFB.conf_from_reduced(torch.from_numpy(al), torch.from_numpy(be),
                                torch.from_numpy(esym), torch.from_numpy(lens),
                                torch.from_numpy(mask), TOH._groups(tp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_conf_path_from_reduced_streams_equals_dense(rng):
    """The port reads confidence and MPM path off the reduced streams; the
    JAX package scatters them to dense [Tp, K, NL] first.  Bit-equal,
    all-zero gammas (state 0) and exact ties (the low state) included."""
    jp, tp = _both()
    Tp, NL = 40, 7
    al = rng.random((Tp, 2, NL)).astype(np.float32)
    be = rng.random((Tp, 2, NL)).astype(np.float32)
    be[5, :, 1] = 0.0
    al[6, 1, 3] = al[6, 0, 3]
    be[6, 1, 3] = be[6, 0, 3]
    esym = rng.integers(0, 4, size=(Tp, NL)).astype(np.int32)
    lens = rng.integers(0, Tp + 1, size=(1, NL)).astype(np.int32)
    jgt = JOH._groups(jp)
    dense = [JFB.scatter_streams(jnp.asarray(x), jgt, jnp.asarray(esym), 8) for x in (al, be)]
    c_d, p_d = JFP._conf_path_from_streams(dense[0], dense[1], jnp.asarray(lens),
                                           jnp.asarray(MASK8))
    c_t, p_t = fb_seq._conf_path_from_streams(
        torch.from_numpy(al), torch.from_numpy(be), torch.from_numpy(esym),
        torch.from_numpy(lens), torch.from_numpy(MASK8), TOH._groups(tp))
    assert np.array_equal(c_t.numpy(), np.asarray(c_d))
    assert np.array_equal(p_t.numpy(), np.asarray(p_d))


def _gammas(tp, obs, lane_T, **kw):
    """Normalized group gammas (low, high) per position, for the tie check."""
    al2, b2, esym2, lens2 = fb_seq._lane_streams(tp, torch.from_numpy(obs), obs.size,
                                                 lane_T, **kw)
    g = (al2 * b2).permute(2, 0, 1).reshape(-1, 2)[: obs.size].double()
    g = g / g.sum(1, keepdim=True).clamp_min(1e-300)
    return g[:, 0].numpy(), g[:, 1].numpy()


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("want_path", [False, True])
def test_seq_posterior_matches_jax(rng, first, want_path):
    """A first span, and a continuation span with threaded enter/exit
    directions and prev_sym, vs ``seq_posterior_pallas(onehot=True,
    fused=True)``."""
    jp, tp = _both()
    obs = _genome(rng, 6000)
    piece = obs if first else obs[2500:]
    kw, jkw = {}, {}
    if not first:
        prev = int(obs[2499])
        enter = np.zeros(8, np.float32)
        enter[[prev, prev + 4]] = rng.random(2) + 0.1  # the group of the symbol before
        last = int(piece[-1])  # the exit direction lives on the last symbol's group
        exit_ = np.zeros(8, np.float32)
        exit_[[last, last + 4]] = rng.random(2) + 0.1
        kw = dict(enter_dir=enter, exit_dir=exit_, first=False, prev_sym=prev)
        jkw = dict(enter_dir=jnp.asarray(enter), exit_dir=jnp.asarray(exit_), first=False,
                   prev_sym=jnp.int32(prev))
    c_j, p_j = JFP.seq_posterior_pallas(jp, jnp.asarray(piece), piece.size,
                                        jnp.asarray(MASK8), want_path=want_path,
                                        lane_T=LANE_T, t_tile=T_TILE, onehot=True,
                                        fused=True, **jkw)
    c_t, p_t = fb_seq.seq_posterior(tp, torch.from_numpy(piece), piece.size, MASK8,
                                    want_path=want_path, lane_T=LANE_T, **kw)
    assert np.all(np.isfinite(c_t.numpy()))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=2e-5)
    if want_path:
        g0, g1 = _gammas(tp, piece, LANE_T, **kw)
        _path_equal_except_ties(p_j, p_t.numpy(), g0, g1)
        assert np.any(p_t.numpy() < 4) and np.any(p_t.numpy() >= 4)
    else:
        assert not p_t.any()


def test_seq_posterior_prepared_equals_inline(rng):
    _, tp = _both()
    obs = torch.from_numpy(_genome(rng, 3000))
    prep = TPR.prepare_seq(4, obs, 3000, lane_T=LANE_T, first=False, prev_sym=2)
    enter = np.full(8, 1 / 8, np.float32)
    inline = fb_seq.seq_posterior(tp, obs, 3000, MASK8, enter_dir=enter, first=False,
                                  want_path=True, lane_T=LANE_T, prev_sym=2)
    held = fb_seq.seq_posterior(tp, obs, 3000, MASK8, enter_dir=enter, first=False,
                                want_path=True, prev_sym=2, prepared=prep)
    assert all(torch.equal(a, b) for a, b in zip(inline, held))
    with pytest.raises(ValueError, match="prev_sym=2"):
        fb_seq.seq_posterior(tp, obs, 3000, MASK8, enter_dir=enter, first=False,
                             prev_sym=1, prepared=prep)
    with pytest.raises(ValueError, match="geometry"):
        fb_seq.seq_posterior(tp, obs[:2000], 2000, MASK8, enter_dir=enter, first=False,
                             prev_sym=2, prepared=prep)


def test_continuation_span_needs_prev_sym(rng):
    _, tp = _both()
    obs = _genome(rng, 1000)
    enter = np.full(8, 1 / 8, np.float32)
    with pytest.raises(ValueError, match="prev_sym"):
        TPO.posterior_sharded(tp, obs, (0, 1, 2, 3), engine="onehot", enter_dir=enter,
                              first=False)
    with pytest.raises(ValueError, match="prev_sym"):
        TPO.transfer_total_sharded(tp, obs, engine="onehot", first=False)
    with pytest.raises(ValueError, match="enter_dir"):
        fb_seq.seq_posterior(tp, torch.from_numpy(obs), 1000, MASK8, first=False, prev_sym=1)


@pytest.mark.parametrize("want_path", [False, True])
def test_batch_posterior_matches_jax(rng, want_path):
    """Independent records, one per lane (ragged, an empty row), vs
    ``batch_posterior_pallas(onehot=True)``."""
    jp, tp = _both()
    N, T = 6, 3000
    chunks = np.stack([_genome(rng, T) for _ in range(N)])
    lengths = np.array([T, 1200, 0, 1, 2999, 700], np.int32)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    c_j, p_j = JFP.batch_posterior_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                          jnp.asarray(MASK8), want_path=want_path,
                                          onehot=True)
    c_t, p_t = fb_seq.batch_posterior(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                      MASK8, want_path=want_path)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=2e-5)
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("first", [True, False])
def test_seq_transfer_total_matches_jax(rng, first):
    jp, tp = _both()
    obs = _genome(rng, 5000)
    piece = obs if first else obs[1700:]
    prev = int(obs[1699])
    t_j = JFP.seq_transfer_total_pallas(jp, jnp.asarray(piece), piece.size, first=first,
                                        lane_T=LANE_T, t_tile=T_TILE, onehot=True,
                                        prev_sym=jnp.int32(prev))
    t_t = fb_seq.seq_transfer_total(tp, torch.from_numpy(piece), piece.size, first=first,
                                    lane_T=LANE_T, prev_sym=prev)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-5, atol=1e-7)
    # Only the entry-group x exit-group block is nonzero.
    assert int((t_t != 0).sum()) == 4
    host = TPO.transfer_total_sharded(tp, piece, engine="onehot", first=first, prev_sym=prev)
    assert host.shape == (8, 8) and np.all(np.isfinite(host))


def test_pick_lane_T():
    assert fb_seq.pick_lane_T(1) == 8
    assert fb_seq.pick_lane_T(3000) == 4096
    assert fb_seq.pick_lane_T(1 << 26) == fb_seq.DEFAULT_LANE_T == 8192


def test_resolve_fb_engine():
    _, tp = _both()
    assert TPO.resolve_fb_engine("auto", tp) == "onehot"
    assert TPO.resolve_fb_engine("onehot", tp) == "onehot"
    assert TPO.resolve_fb_engine("pallas", tp) == "pallas"
    assert TPO.resolve_fb_engine("xla", tp) == "xla"  # the generic lane path
    with pytest.raises(ValueError):
        TPO.resolve_fb_engine("bogus", tp)


def test_call_islands_obs_matches_jax(rng):
    for _ in range(5):
        obs = _genome(rng, 4000)
        path = rng.integers(0, 2, size=4000)
        path[500:1200] = 0
        calls_j = JIS.call_islands_obs(path, obs, island_states=(0,), min_len=5)
        calls_t = TIS.call_islands_obs(path, obs, island_states=(0,), min_len=5)
        assert calls_t.format_lines() == calls_j.format_lines()
    assert len(TIS.call_islands_obs(np.zeros(0), np.zeros(0), island_states=(0,))) == 0


def test_npy_stream_writer_matches_jax(tmp_path, rng):
    parts = [rng.random(n).astype(np.float32) for n in (0, 17, 1000)]
    for cls, name in ((JWriter, "j"), (TWriter, "t")):
        with cls(str(tmp_path / f"{name}.npy"), np.float32) as w:
            for p in parts:
                w.write(p)
    data = (tmp_path / "t.npy").read_bytes()
    assert data == (tmp_path / "j.npy").read_bytes()
    assert np.array_equal(np.load(tmp_path / "t.npy"), np.concatenate(parts))
