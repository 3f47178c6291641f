"""The port's scoring pass (``ops.forward_backward.sequence_loglik``) vs
the JAX package's.

The JAX function is one serial scan; the port cuts the record into lanes,
threads exact entering directions through the lane products (B7 / B17) and
runs a forward-only chain per lane (the kernels of ``csrc/loglik.cu``,
their plain versions here on the CPU).  The two agree within rtol 1e-5
(XLA contracts the scan's matmul into FMAs; the port rounds every
operation), whatever the lane length.  The JAX PAD rule holds: a symbol
>= S or a position past ``length`` is an identity step, a PAD first
position included; an impossible observation scores -inf, never nan.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JH
from cpgisland_tpu.ops.forward_backward import sequence_loglik as j_loglik
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot, fb_pallas
from cpgisland_tpu_torch.ops import loglik as TL
from cpgisland_tpu_torch.ops.forward_backward import sequence_loglik as t_loglik

_MODELS = {
    "durbin8": JP.durbin_cpg8,
    "two_state": JP.two_state_cpg,
    "null4": lambda: JP.null_background(4),
    "null16": lambda: JP.null_background(16),
    "dinuc": JP.dinuc_cpg,
}


def _both(name):
    jp = _MODELS[name]()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _stream(name, n, seed=0, pads=()):
    """A base stream with a GC-rich stretch and PAD runs ``pads``, pair
    recoded for the order-2 models.  The codec makes the pair after a PAD
    run the self-context pair, which dinuc_cpg's structural zeros reject
    unless the base before the run matches; here each such pair takes the
    last real base before the run as its context, so the in-length PAD runs
    stay identity steps of a possible record."""
    rng = np.random.default_rng(seed)
    base = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    m = min(700, n // 2)
    base[n // 3 : n // 3 + m] = rng.choice(4, size=m, p=[0.15, 0.35, 0.35, 0.15])
    for a, b in pads:
        base[a:b] = 4
    if name not in ("null16", "dinuc"):
        return base
    obs = JC.recode_pairs(base)
    for a, b in pads:
        if a > 0 and b < n:
            obs[b] = base[a - 1] * 4 + base[b]
    return obs


# (name, n, length, PAD edits): ragged length, PAD-first, in-length PAD runs.
_CASES = [
    ("full", 5000, None, ()),
    ("ragged", 5000, 3217, ()),
    ("pad_first", 5000, None, ((0, 1),)),
    ("pad_lead_run", 5000, 4100, ((0, 37),)),
    ("pad_runs", 6000, None, ((900, 1300), (2500, 2501), (5990, 6000))),
]


@pytest.mark.parametrize("name", list(_MODELS))
@pytest.mark.parametrize("case", [c[0] for c in _CASES])
def test_sequence_loglik_matches_jax(name, case):
    _, n, length, pads = next(c for c in _CASES if c[0] == case)
    jp, tp = _both(name)
    obs = _stream(name, n, pads=pads)
    want = float(j_loglik(jp, jnp.asarray(obs), n if length is None else length))
    got = t_loglik(tp, obs, length, lane_T=512)
    assert isinstance(got, float) and math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["durbin8", "two_state"])
def test_sequence_loglik_is_lane_free(name):
    """The lanes cut the work, not the result: any lane length gives the
    same total up to float64 rounding of the lane sums."""
    _, tp = _both(name)
    obs = _stream(name, 7000, seed=3)
    ref = t_loglik(tp, obs, lane_T=1 << 13)
    for lt in (64, 1000, 4096):
        assert abs(t_loglik(tp, obs, lane_T=lt) - ref) <= 1e-9 * abs(ref)


def test_sequence_loglik_all_pad_and_empty_score_zero():
    jp, tp = _both("durbin8")
    obs = np.full(300, 4, np.uint8)
    assert t_loglik(tp, obs) == 0.0 == float(j_loglik(jp, jnp.asarray(obs)))
    assert t_loglik(tp, _stream("durbin8", 300), 0) == 0.0


def test_impossible_observation_scores_minus_inf_reduced():
    """A non-chaining pair hits dinuc_cpg's structural zeros: -inf on both
    sides, never nan, wherever it falls."""
    jp, tp = _both("dinuc")
    obs = _stream("dinuc", 3000, seed=5)
    for pos in (1, 1700, 2999):
        bad = obs.copy()
        b = int(bad[pos - 1]) % 4  # the current base of the previous pair
        bad[pos] = ((b + 1) % 4) * 4 + int(bad[pos]) % 4  # its left context is not b
        want = float(j_loglik(jp, jnp.asarray(bad)))
        got = t_loglik(tp, bad, lane_T=256)
        assert want == -math.inf and got == -math.inf, (pos, want, got)


@pytest.mark.parametrize("first", [True, False])
def test_impossible_observation_scores_minus_inf_dense(first):
    """An emission of probability 0 in every state: -inf, at the first
    position (c0 == 0) or later."""
    B = np.array([[0.5, 0.5, 0.0, 0.0], [0.2, 0.8, 0.0, 0.0]])
    jp = JH.from_probs(np.array([0.4, 0.6]), np.array([[0.9, 0.1], [0.2, 0.8]]), B)
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    obs = np.random.default_rng(1).integers(0, 2, size=2000).astype(np.uint8)
    obs[0 if first else 1234] = 2
    assert float(j_loglik(jp, jnp.asarray(obs))) == -math.inf
    assert t_loglik(tp, obs, lane_T=128) == -math.inf


def test_scoring_engine_routes_like_the_posterior():
    assert TL.scoring_engine(_both("durbin8")[1]) == "onehot"
    assert TL.scoring_engine(_both("dinuc")[1]) == "onehot"
    assert TL.scoring_engine(_both("two_state")[1]) == "pallas"
    assert TL.scoring_engine(_both("null16")[1]) == "pallas"
    jp = JP.random_hmm(__import__("jax").random.PRNGKey(0), 12, 4)
    # Outside both chains' domains: the JAX function's serial chain.
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    assert TL.scoring_engine(tp) == "xla"
    obs = np.random.default_rng(3).integers(0, 4, size=3000).astype(np.uint8)
    np.testing.assert_allclose(TL.sequence_loglik(tp, obs),
                               float(j_loglik(jp, jnp.asarray(obs))),
                               rtol=1e-5)


def test_chain_wrappers_refuse_bad_operands():
    tab = fb_onehot.prob_tab_ext(_both("durbin8")[1], fb_onehot._groups(_both("durbin8")[1]))
    tabs = tab[None]  # one member
    pair = torch.zeros((8, 3), dtype=torch.int32)
    assert TL.oh_loglik(pair, torch.full((1, 2, 3), 0.5), tabs).shape == (1, 3)
    with pytest.raises(ValueError):
        TL.oh_loglik(pair, torch.zeros((1, 3, 3)), tabs)
    with pytest.raises(ValueError):
        TL.oh_loglik(pair.long(), torch.zeros((1, 2, 3)), tabs)
    with pytest.raises(ValueError):
        TL.oh_loglik(pair, torch.zeros((2, 3)), tab)
    A, B, _ = fb_pallas.tables(_both("two_state")[1])
    with pytest.raises(ValueError):
        TL.fb_loglik(pair, torch.zeros((3, 3)), A, B)
    with pytest.raises(ValueError):
        TL.fb_loglik(torch.zeros((0, 3), dtype=torch.int32), torch.zeros((2, 3)), A, B)
