"""The port's model-family layer vs the JAX package: the pair recode, the
partition oracle, the presets of the family (dinuc_cpg, null_background)
and the members registry, plus the port's own routing rules
(``family.stacked.stack_groups``, the baseline and winner-track algebra,
the options that are not ported).

Tables are held within one float32 ulp, as tests/test_torch_models.py holds
the flagship's: XLA:CPU's float32 ``log`` is not correctly rounded.
"""

import jax
import numpy as np
import pytest
import torch

from cpgisland_tpu import family as JF
from cpgisland_tpu.family import compare as JCMP
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JH
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu_torch import family as TF
from cpgisland_tpu_torch.family import stacked as TS
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.train.backends import FamilyEStep
from cpgisland_tpu_torch.utils import codec as TC


def _ulp_close(t, j):
    t = t.numpy()
    j = np.asarray(j)
    finite = np.isfinite(j) & (j > -1e29)
    np.testing.assert_array_equal(t > -1e29, finite)
    np.testing.assert_allclose(t[finite], j[finite], rtol=0,
                               atol=float(np.abs(np.spacing(j[finite])).max(initial=0)))


@pytest.mark.parametrize("name", ["dinuc_cpg", "null4", "null16", "durbin8", "two_state"])
def test_presets_match_jax(name):
    make = {
        "dinuc_cpg": (JP.dinuc_cpg, TP.dinuc_cpg),
        "null4": (lambda: JP.null_background(4), lambda: TP.null_background(4)),
        "null16": (lambda: JP.null_background(16), lambda: TP.null_background(16)),
        "durbin8": (JP.durbin_cpg8, TP.durbin_cpg8),
        "two_state": (JP.two_state_cpg, TP.two_state_cpg),
    }[name]
    jp, tp = make[0](), make[1]()
    for f in ("log_pi", "log_A", "log_B"):
        _ulp_close(getattr(tp, f), getattr(jp, f))


def test_family_constants_match_jax():
    assert TP.DINUC_ISLAND_STATES == JP.DINUC_ISLAND_STATES
    assert TP.CPG_PAIR == JP.CPG_PAIR
    np.testing.assert_array_equal(TP._background_stationary(), JP._background_stationary())
    with pytest.raises(ValueError):
        TP.null_background(8)


@pytest.mark.parametrize("partition", [2, None])
def test_random_hmm_is_stochastic_and_seeded(partition):
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = TP.random_hmm(g(), 8, 4, partition=partition)
    b = TP.random_hmm(g(), 8, 4, partition=partition)
    for x, y in zip((a.pi, a.A, a.B), (b.pi, b.A, b.B)):
        assert torch.equal(x, y)
        assert torch.allclose(x.sum(-1), torch.ones(()), atol=1e-6)
    assert TF.reduced_eligible(a) == (partition == 2)
    with pytest.raises(ValueError):
        TP.random_hmm(g(), 7, 4, partition=2)


@pytest.mark.parametrize("prev", [None, 0, 2, 4])
@pytest.mark.parametrize("n", [0, 1, 2, 57])
def test_recode_pairs_matches_jax(prev, n):
    rng = np.random.default_rng(n)
    s = rng.integers(0, 4, size=n).astype(np.uint8)
    if n > 10:
        s[5:9] = 4  # a masked run: the position after it is self-context
    want = JC.recode_pairs(s, prev=prev)
    got = TC.recode_pairs(s, prev=prev)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_recode_pairs_refuses_wide_alphabets():
    with pytest.raises(ValueError):
        TC.recode_pairs(np.zeros(3, np.uint8), n_symbols=16)


def _random_np(seed, K, S, partition):
    jp = JP.random_hmm(jax.random.PRNGKey(seed), K, S, partition=partition)
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


@pytest.mark.parametrize("case", ["durbin8", "dinuc", "two_state", "null16", "g4", "overlap"])
def test_partition_of_matches_jax(case):
    if case == "durbin8":
        jp = JP.durbin_cpg8()
    elif case == "dinuc":
        jp = JP.dinuc_cpg()
    elif case == "two_state":
        jp = JP.two_state_cpg()
    elif case == "null16":
        jp = JP.null_background(16)
    elif case == "g4":
        jp, _ = _random_np(3, 16, 4, 4)
    else:
        # Overlapping supports: no partition.
        B = np.array([[0.5, 0.5, 0, 0], [0, 0.5, 0.5, 0], [0, 0, 0.5, 0.5], [0.5, 0, 0, 0.5]])
        jp = JH.from_probs(np.full(4, 0.25), np.full((4, 4), 0.25), B)
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    want, got = JF.partition_of(jp), TF.partition_of(tp)
    if want is None:
        assert got is None
        return
    assert (got.n_states, got.n_symbols, got.blocks, got.onehot, got.uniform, got.reduced) == (
        want.n_states, want.n_symbols, want.blocks, want.onehot, want.uniform, want.reduced)
    np.testing.assert_array_equal(got.block_of_symbol, want.block_of_symbol)
    np.testing.assert_array_equal(got.block_of_state, want.block_of_state)


@pytest.mark.parametrize("name", list(JF.MEMBER_NAMES))
def test_builtin_members_match_jax(name):
    j, t = JF.builtin_member(name), TF.builtin_member(name)
    assert (t.name, t.island_states, t.order, t.description, t.is_null) == (
        j.name, j.island_states, j.order, j.description, j.is_null)
    for f in ("log_pi", "log_A", "log_B"):
        _ulp_close(getattr(t.params, f), getattr(j.params, f))
    assert TF.MEMBER_NAMES == JF.MEMBER_NAMES
    assert (t.partition is None) == (j.partition is None)


def test_member_encode_matches_jax():
    s = np.random.default_rng(1).integers(0, 4, size=40).astype(np.uint8)
    for name in ("durbin8", "dinuc_cpg"):
        for prev in (None, 3):
            np.testing.assert_array_equal(TF.builtin_member(name).encode(s, prev=prev),
                                          JF.builtin_member(name).encode(s, prev=prev))
    s[7] = 4
    with pytest.raises(ValueError, match="PAD-free"):
        TF.builtin_member("dinuc_cpg").encode(s)


def test_member_construction_checks():
    with pytest.raises(ValueError, match="order"):
        TF.Member("x", TP.durbin_cpg8(), (0,), 3)
    with pytest.raises(ValueError, match="16-symbol"):
        TF.Member("x", TP.durbin_cpg8(), (0,), 2)
    with pytest.raises(ValueError, match="outside"):
        TF.Member("x", TP.two_state_cpg(), (2,), 1)
    with pytest.raises(ValueError, match="unknown family member"):
        TF.builtin_member("nope")
    with pytest.raises(ValueError, match="duplicate"):
        TF.members_from_names(["null", "null"])
    assert [m.name for m in TF.default_members()] == ["durbin8", "two_state", "null"]


@pytest.mark.parametrize("model", ["durbin8", "dinuc", "two_state", "null4"])
def test_member_from_params_matches_jax(model):
    jp = {"durbin8": JP.durbin_cpg8, "dinuc": JP.dinuc_cpg, "two_state": JP.two_state_cpg,
          "null4": lambda: JP.null_background(4)}[model]()
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    j, t = JF.member_from_params("m", jp), TF.member_from_params("m", tp)
    assert (t.island_states, t.order) == (j.island_states, j.order)
    if tp.n_states > 1:
        t2 = TF.member_from_params("m", tp, island_states=(1, 0))
        assert t2.island_states == (0, 1)


def test_member_from_params_refuses_other_alphabets():
    with pytest.raises(ValueError, match="infer"):
        TF.member_from_params("m", TP.random_hmm(torch.Generator().manual_seed(0), 3, 5))


def _m(name, order=1, null=False):
    params = TP.null_background(4 if order == 1 else 16) if null else (
        TP.durbin_cpg8() if order == 1 else TP.dinuc_cpg())
    return TF.Member(name, params, () if null else (0,), order)


def test_stack_groups_takes_only_resolved_onehot_members():
    members = [_m("a"), _m("b"), _m("two"), _m("n", null=True), _m("d", 2), _m("e", 2)]
    engines = ["onehot", "onehot", "pallas", None, "onehot", "onehot"]
    assert TS.stack_groups(members, engines) == {1: [0, 1], 2: [4, 5]}
    assert TS.stack_groups(members, engines, enabled=False) == {}
    # A singleton gains nothing and stays on the sequential arm.
    assert TS.stack_groups(members[:1] + members[2:4], ["onehot", "pallas", None]) == {}
    assert TS.stack_groups(members, ["onehot", "pallas", "pallas", None, "onehot", "xla"]) == {}


def test_resolve_baseline_and_winner_track_match_jax():
    jm = [JF.builtin_member(n) for n in ("durbin8", "two_state", "null")]
    tm = [TF.builtin_member(n) for n in ("durbin8", "two_state", "null")]
    for b in (None, "durbin8", "two_state"):
        assert TF.resolve_baseline(tm, b) == JF.resolve_baseline(jm, b)
    with pytest.raises(ValueError):
        TF.resolve_baseline(tm, "nope")
    assert TF.resolve_baseline(tm[:2], None) == 0
    confs = np.random.default_rng(2).random((3, 500)).astype(np.float32)
    confs[1, :50] = confs[0, :50]  # ties go to the lower index
    for th in (0.0, 0.5, 0.9):
        np.testing.assert_array_equal(TF.winner_track(confs, th), JF.winner_track(confs, th))
    with pytest.raises(ValueError):
        TF.winner_track(confs, -0.1)


def test_winner_calls_match_jax():
    rng = np.random.default_rng(4)
    symbols = rng.integers(0, 4, size=3000).astype(np.uint8)
    symbols[1000:1400] = rng.choice([1, 2], size=400)
    winner = np.full(3000, -1, np.int8)
    winner[990:1420] = 0
    winner[1420:1500] = 1
    jm = [JF.builtin_member(n) for n in ("durbin8", "two_state", "null")]
    tm = [TF.builtin_member(n) for n in ("durbin8", "two_state", "null")]
    for ml in (None, 100):
        assert TF.winner_calls(tm, winner, symbols, min_len=ml).format_lines() == \
            JCMP.winner_calls(jm, winner, symbols, min_len=ml).format_lines()


def test_unported_options_raise_naming_their_item():
    members = TF.default_members()
    s = np.zeros(100, np.uint8)
    for kw, item in (({"sessions": {}}, "A13"), ({"supervisor": object()}, "A12"),
                     ({"streams_handle": object()}, "A13")):
        with pytest.raises(NotImplementedError, match=item):
            TF.compare_record(members, s, device="cpu", **kw)
    assert FamilyEStep(fuse_fb=False).fuse_fb is False  # the split arm runs now
    with pytest.raises(ValueError, match="duplicate"):
        TF.compare_record([members[0], members[0]], s, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        TF.compare_record([], s, device="cpu")
