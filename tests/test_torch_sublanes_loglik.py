"""The scoring kernels in sub-lanes: the port's G > 1 plain versions vs the
JAX package's ``sequence_loglik`` and vs the port's own one chain.

A scoring lane of ``loglik.LOGLIK_SUBLANES_FROM`` (8,192) steps or more runs
as G = ``loglik.loglik_sublanes(Tp, K)`` sub-lanes: each sub-lane's product
of its step matrices, each sub-lane's entering direction composed from the
lane's through the products before it and normalized once, each
sub-lane's chain, its float64 sums added in order.  The chain is degree 0
in the vector it carries, so the score is the one chain's in exact
arithmetic; in float32 the two differ in the last bits.  The records here
run in lanes of 8,192 steps (G = 32 sub-lanes of 256), a few lanes each, so
the plain loops stay cheap: the G > 1 score agrees with the JAX scan within
rtol 1e-5 (the bound of ``tests/test_torch_loglik.py``) and with G = 1
within 1e-9 relative (that of its ``test_sequence_loglik_is_lane_free``),
an impossible observation scores -inf and never nan wherever it falls, and
each member of a stacked group scores its own score bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JH
from cpgisland_tpu.ops.forward_backward import sequence_loglik as j_loglik
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot
from cpgisland_tpu_torch.ops import loglik as TL

from test_torch_loglik import _MODELS, _both, _stream

LANE_T = 8192  # G = 32 sub-lanes of 256 steps
N = 20_000  # three lanes, the last one ragged

# (name, length, PAD edits): a ragged length, a PAD first position, PAD runs
# across sub-lane boundaries (512 and 768 in lane 0, 1,024 in lane 1), and a
# PAD lead that puts the first real step in sub-lane 5.
_CASES = [
    ("ragged", 13_217, ()),
    ("pad_first", None, ((0, 1),)),
    ("pad_across_boundary", None, ((400, 700), (LANE_T + 808, LANE_T + 1108))),
    ("first_real_past_sub0", 16_000, ((0, 1500),)),
]


def test_loglik_sublanes_rule(monkeypatch):
    """G: 1 below 8,192 steps and for a dense chain of K > 4, else Tp //
    LOGLIK_SUBLANE_T capped at 32 (256 steps: 32 on every such lane); the
    reduced chain's default K is its group."""
    assert TL.loglik_sublanes(8191) == TL.loglik_sublanes(4096) == 1
    assert TL.loglik_sublanes(8192) == TL.loglik_sublanes(8192, 2) == 32
    assert TL.loglik_sublanes(8192, 1) == TL.loglik_sublanes(8192, 4) == 32
    assert TL.loglik_sublanes(8192, 5) == TL.loglik_sublanes(1 << 16, 8) == 1
    assert TL.loglik_sublanes(1 << 16) == TL.loglik_sublanes(1 << 20, 3) == 32
    monkeypatch.setattr(TL, "LOGLIK_SUBLANE_T", 512)
    assert TL.loglik_sublanes(8192) == 16 and TL.loglik_sublanes(12_000) == 23
    assert TL.loglik_sublanes(8191) == 1 and TL.loglik_sublanes(1 << 16) == 32


def test_lanes_per_block_rule():
    """The sub-lane kernels' lanes a block: 32 while the blocks cover the
    card's SMs, halved until they do, down to 1."""
    assert TL._lanes_per_block(8192, 1, 132) == TL._lanes_per_block(4224, 1, 132) == 32
    assert TL._lanes_per_block(4192, 1, 132) == 16
    assert TL._lanes_per_block(1024, 1, 132) == 4 and TL._lanes_per_block(1024, 2, 132) == 8
    assert TL._lanes_per_block(2, 1, 132) == TL._lanes_per_block(33, 3, 132) == 1
    assert TL._lanes_per_block(2, 1, 0) == 32


@pytest.mark.parametrize("name", list(_MODELS))
@pytest.mark.parametrize("case", [c[0] for c in _CASES])
def test_sublane_loglik_matches_jax(name, case):
    _, length, pads = next(c for c in _CASES if c[0] == case)
    jp, tp = _both(name)
    obs = _stream(name, N, seed=7, pads=pads)
    want = float(j_loglik(jp, jnp.asarray(obs), N if length is None else length))
    got = TL.sequence_loglik(tp, obs, length, lane_T=LANE_T)
    assert isinstance(got, float) and math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", list(_MODELS))
def test_sublanes_agree_with_one_chain(name, monkeypatch):
    """The same 8 Ki-step lanes in one chain (G = 1), and the record in
    4 Ki-step lanes: within 1e-9 relative of the G > 1 score."""
    _, tp = _both(name)
    obs = _stream(name, N, seed=11, pads=((400, 700),))
    sub = TL.sequence_loglik(tp, obs, lane_T=LANE_T)
    short = TL.sequence_loglik(tp, obs, lane_T=4096)
    monkeypatch.setattr(TL, "LOGLIK_SUBLANE_T", LANE_T)  # G = 1
    one = TL.sequence_loglik(tp, obs, lane_T=LANE_T)
    for ref in (one, short):
        assert abs(sub - ref) <= 1e-9 * abs(ref), (sub, ref)


@pytest.mark.parametrize("pos", [700, 1024, LANE_T, LANE_T + 1536, 2 * LANE_T + 512])
def test_impossible_at_a_sublane_scores_minus_inf_reduced(pos):
    """A non-chaining pair hits dinuc_cpg's structural zeros inside a
    sub-lane, at a sub-lane's first step (lane 0, and later lanes' first
    and inner sub-lanes): -inf on both sides, never nan."""
    jp, tp = _both("dinuc")
    bad = _stream("dinuc", N, seed=5)
    b = int(bad[pos - 1]) % 4  # the current base of the previous pair
    bad[pos] = ((b + 1) % 4) * 4 + int(bad[pos]) % 4  # its left context is not b
    assert float(j_loglik(jp, jnp.asarray(bad))) == -math.inf
    assert TL.sequence_loglik(tp, bad, lane_T=LANE_T) == -math.inf


@pytest.mark.parametrize("pos", [1, 700, 512, LANE_T, LANE_T + 1024])
def test_impossible_at_a_sublane_scores_minus_inf_dense(pos):
    """An emission of probability 0 in every state at a sub-lane's first
    step or inside one, in the record's first lane or a later one: the
    sub-lanes after it enter with a zero message, and the score is -inf,
    never nan (per lane too)."""
    B = np.array([[0.5, 0.5, 0.0, 0.0], [0.2, 0.8, 0.0, 0.0]])
    jp = JH.from_probs(np.array([0.4, 0.6]), np.array([[0.9, 0.1], [0.2, 0.8]]), B)
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    obs = np.random.default_rng(1).integers(0, 2, size=N).astype(np.uint8)
    obs[pos] = 2
    assert float(j_loglik(jp, jnp.asarray(obs))) == -math.inf
    assert TL.sequence_loglik(tp, obs, lane_T=LANE_T) == -math.inf
    sel = torch.from_numpy(obs[: 2 * LANE_T].astype(np.int32).reshape(2, LANE_T).T.copy())
    A, Bt = tp.A.float(), tp.B.float()
    lanes = TL.fb_loglik(sel, torch.full((2, 2), 0.5), A, Bt)
    assert not torch.isnan(lanes).any() and (lanes == -math.inf).any()


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
def test_stacked_members_equal_their_own_scores(S, M):
    """sequence_loglik_stacked at G > 1 (one B21 and one scoring launch for
    the group) gives each member its own sequence_loglik bit for bit."""
    first = JP.durbin_cpg8() if S == 4 else JP.dinuc_cpg()
    jps = [first] + [JP.random_hmm(jax.random.PRNGKey(m), 2 * S, S, partition=2)
                     for m in range(1, M)]
    tps = [params_from_numpy(p.log_pi, p.log_A, p.log_B) for p in jps]
    obs = _stream("durbin8" if S == 4 else "dinuc", N, seed=3, pads=((9000, 9400),))
    stacked = TL.sequence_loglik_stacked(tps, obs, 17_000, lane_T=LANE_T)
    assert stacked == [TL.sequence_loglik(p, obs, 17_000, lane_T=LANE_T) for p in tps]
    assert all(math.isfinite(x) for x in stacked)


def test_reduced_kernel_plain_members_are_independent(monkeypatch):
    """The reduced chain's G > 1 plain version on M = 3 tables: each
    member's lane sums equal an M = 1 call's bit for bit, and the sums sit
    within 1e-9 relative of the one chain's."""
    rng = np.random.default_rng(4)
    _, tp = _both("durbin8")
    jps = [JP.random_hmm(jax.random.PRNGKey(m), 8, 4, partition=2) for m in (1, 2)]
    members = [tp] + [params_from_numpy(p.log_pi, p.log_A, p.log_B) for p in jps]
    tabs = fb_onehot.stacked_tables(members)[1]
    pair = rng.integers(0, 16, size=(LANE_T, 3)).astype(np.int32)
    pair[rng.random(pair.shape) < 0.02] = 16 + 2  # PAD pairs
    pair[3000:, 2] = 16 + 1  # a PAD tail
    pair2 = torch.from_numpy(pair)
    e = rng.random((3, 2, 3)).astype(np.float32) + 0.01
    enter = torch.from_numpy(e / e.sum(axis=1, keepdims=True))
    got = TL.oh_loglik(pair2, enter, tabs)
    for m in range(3):
        one = TL.oh_loglik(pair2, enter[m : m + 1], tabs[m : m + 1].contiguous())
        assert torch.equal(one[0], got[m])
    monkeypatch.setattr(TL, "LOGLIK_SUBLANE_T", LANE_T)  # G = 1
    torch.testing.assert_close(got, TL.oh_loglik_plain(pair2, enter, tabs), rtol=1e-9, atol=0)
