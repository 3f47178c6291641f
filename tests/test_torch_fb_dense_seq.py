"""The dense whole-sequence forward-backward of the PyTorch port vs the
JAX package and the float64 oracle, on the CPU.

The port's dense engine ("pallas": B16-B19 through their plain versions
here) against the JAX package's dense Pallas route (``onehot=False``, its
kernels in interpret mode): the whole-sequence posterior
``seq_posterior`` (path and confidence-only) and ``seq_transfer_total``,
and span threading through ``enter_dir`` / ``exit_dir`` against the
one-pass result.  The JAX side pads lanes to 128 and combines the lane
products in another scan tree, so results agree within float32 rounding:
confidence within atol 2e-5 (the JAX package's own posterior pin),
transfer directions within rtol 1e-5, MPM paths equal except at
near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.parallel import posterior as TPO

from oracle import forward_backward_oracle

LANE_T, T_TILE = 512, 256


def _model(name):
    """(jax params, torch params) with identical float32 log tables:
    two_state, a random 5-state model over 3 symbols and a random 8-state
    one over 4."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "two_state":
        jp = JP.two_state_cpg()
    else:
        K, S = {"rand5": (5, 3), "rand8": (8, 4)}[name]
        A = rng.dirichlet(np.ones(K) * 0.5, size=K) + np.eye(K) * 4
        A /= A.sum(1, keepdims=True)
        jp = JHmm.from_probs(rng.dirichlet(np.ones(K)), A,
                             rng.dirichlet(np.ones(S), size=K))
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _probs(p):
    return [np.exp(np.asarray(x, np.float64)) for x in (p.log_pi, p.log_A, p.log_B)]


def _obs(rng, n, S):
    """Symbols with planted stretches rich in the upper half of the alphabet."""
    s = rng.integers(0, S, size=n).astype(np.uint8)
    for a in range(200, n - 600, 1500):
        s[a : a + 500] = rng.integers(S // 2, S, size=500)
    return s


def _mask(K):
    return (np.arange(K) < max(1, K // 2)).astype(np.float32)


# -- whole-sequence posterior -----------------------------------------------------


def _gamma(tp, piece, lane_T, **kw):
    """Normalized float64 gammas of the port's dense streams [T, K]."""
    alphas, betas, _ = fb_seq._lane_streams_dense(tp, torch.from_numpy(piece), piece.size,
                                                  lane_T, **kw)
    g = (alphas * betas).permute(2, 0, 1).reshape(-1, tp.n_states)[: piece.size].double()
    return (g / g.sum(1, keepdim=True).clamp_min(1e-300)).numpy()


def _path_equal_except_ties(want, got, gamma, tol=1e-5):
    diff = np.flatnonzero(np.asarray(want) != np.asarray(got))
    if diff.size:
        g = np.sort(gamma[diff], axis=1)
        assert np.all(g[:, -1] - g[:, -2] <= tol), diff[:10]


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("want_path", [False, True])
def test_dense_seq_posterior_matches_jax(rng, first, want_path):
    """A first span, and a continuation span with threaded enter/exit
    directions (no prev symbol: the dense engine reads none), vs
    ``seq_posterior_pallas(onehot=False)``."""
    jp, tp = _model("rand5")
    K, S = 5, 3
    obs = _obs(rng, 3500, S)
    piece = obs if first else obs[1300:]
    kw, jkw = {}, {}
    if not first:
        enter = (rng.random(K) + 0.1).astype(np.float32)
        exit_ = (rng.random(K) + 0.1).astype(np.float32)
        kw = dict(enter_dir=enter, exit_dir=exit_, first=False)
        jkw = dict(enter_dir=jnp.asarray(enter), exit_dir=jnp.asarray(exit_), first=False)
    c_j, p_j = JFP.seq_posterior_pallas(jp, jnp.asarray(piece), piece.size,
                                        jnp.asarray(_mask(K)), want_path=want_path,
                                        lane_T=LANE_T, t_tile=T_TILE, onehot=False, **jkw)
    c_t, p_t = fb_seq.seq_posterior(tp, torch.from_numpy(piece), piece.size, _mask(K),
                                    want_path=want_path, lane_T=LANE_T, engine="pallas", **kw)
    assert c_t.shape == (piece.size,) and np.all(np.isfinite(c_t.numpy()))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=2e-5)
    if want_path:
        _path_equal_except_ties(p_j, p_t.numpy(), _gamma(tp, piece, LANE_T, **kw))
        assert len(np.unique(p_t.numpy())) > 1
    else:
        assert not p_t.any()
    if first:
        gamma, _, _ = forward_backward_oracle(*_probs(jp), piece)
        np.testing.assert_allclose(c_t.numpy(), gamma[:, _mask(K) > 0].sum(1), atol=2e-5)


@pytest.mark.parametrize("first", [True, False])
def test_dense_seq_transfer_total_matches_jax(rng, first):
    """B17 and the lane scan: the span's [K, K] operator, normalized to
    total 1, within rtol 1e-5."""
    jp, tp = _model("rand8")
    obs = _obs(rng, 3000, 4)
    piece = obs if first else obs[900:]
    t_j = np.asarray(JFP.seq_transfer_total_pallas(jp, jnp.asarray(piece), piece.size,
                                                   first=first, lane_T=LANE_T,
                                                   t_tile=T_TILE, onehot=False))
    t_t = fb_seq.seq_transfer_total(tp, torch.from_numpy(piece), piece.size, first=first,
                                    lane_T=LANE_T, engine="pallas").numpy()
    np.testing.assert_allclose(t_t / t_t.sum(), t_j / t_j.sum(), rtol=1e-5, atol=1e-8)
    host = TPO.transfer_total_sharded(tp, piece, engine="pallas", first=first)
    assert host.shape == (8, 8) and np.all(np.isfinite(host)) and np.all(host > 0)


@pytest.mark.parametrize("n_spans", [2, 3])
def test_dense_spans_thread_to_one_pass(rng, monkeypatch, n_spans):
    """Span threading on the dense engine: each span's transfer total (B17),
    the host threading of ``pipeline._thread_spans``, then each span's
    posterior from its threaded enter/exit directions — the one-pass
    confidence within atol 2e-5 and the same MPM path off near-ties."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", LANE_T)
    _, tp = _model("rand5")
    obs = _obs(rng, 4000, 3)
    span = -(-obs.size // n_spans)
    isl = (0, 1)
    one_c, one_p = TPO.posterior_sharded(tp, obs, isl, engine="pallas", want_path=True)
    starts = range(0, obs.size, span)
    totals = [TPO.transfer_total_sharded(tp, obs[lo : lo + span], engine="pallas",
                                         first=lo == 0) for lo in starts]
    enters, exits = TPL._thread_spans(tp, int(obs[0]), totals)
    conf, path = [], []
    for s, lo in enumerate(starts):
        c, p = TPO.posterior_sharded(tp, obs[lo : lo + span], isl, engine="pallas",
                                     enter_dir=None if s == 0 else enters[s],
                                     exit_dir=exits[s], first=s == 0, want_path=True)
        conf.append(c)
        path.append(p)
    np.testing.assert_allclose(np.concatenate(conf), one_c, rtol=0, atol=2e-5)
    _path_equal_except_ties(one_p, np.concatenate(path), _gamma(tp, obs, LANE_T))


def test_dense_prep_needs_no_prev_sym(rng):
    """The dense span prep keeps the time-major lane layouts and no pair
    stream; a continuation span needs no prev symbol, and a prep serves
    only its own engine."""
    _, tp = _model("two_state")
    obs = torch.from_numpy(_obs(rng, 2000, 4))
    prep = TPR.prepare_seq(4, obs, 2000, lane_T=LANE_T, first=False, onehot=False)
    assert prep.pair2 is None and prep.prev_key is None
    assert prep.steps2.shape == prep.sel2.shape == (LANE_T, 4)
    assert prep.steps2.is_contiguous() and prep.sel2.is_contiguous()
    enter = np.array([0.3, 0.7], np.float32)
    held = fb_seq.seq_posterior(tp, obs, 2000, [1, 0], enter_dir=enter, first=False,
                                want_path=True, prepared=prep, engine="pallas")
    inline = fb_seq.seq_posterior(tp, obs, 2000, [1, 0], enter_dir=enter, first=False,
                                  want_path=True, lane_T=LANE_T, engine="pallas")
    assert all(torch.equal(a, b) for a, b in zip(held, inline))
    with pytest.raises(ValueError, match="dense"):
        fb_seq.seq_posterior(tp, obs, 2000, [1, 0], enter_dir=enter, first=False,
                             prev_sym=1, prepared=prep, engine="onehot")
    with pytest.raises(ValueError, match="enter_dir"):
        fb_seq.seq_posterior(tp, obs, 2000, [1, 0], first=False, engine="pallas")
    c, _ = TPO.posterior_sharded(tp, obs.numpy(), (0,), engine="pallas", enter_dir=enter,
                                 first=False)
    assert c.shape == (2000,)
