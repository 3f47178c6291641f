"""``compare`` of the port vs the JAX package's, on a small multi-record FASTA.

Off the TPU the JAX routers resolve ``engine="auto"`` to "xla", while the
port resolves it as the TPU does (the flagship to the reduced engine,
two_state to the dense one).  So the JAX side gets per-member serving
sessions that match the port's resolution (as tests/test_multimodel.py
does), or, for an all-reduced cast, ``engine="onehot"`` on both sides.  Its
Pallas functions run as its own tests run them off the TPU.

What must hold: the report's header, ``# record`` lines and winner-track
lines byte-identical; per ``# model`` line the island count identical and
the loglik within rtol 1e-5 (XLA contracts the scoring scan into FMAs and
sums it in float32; the port rounds every operation and sums its lanes in
float64).  A log-odds is a difference of two logliks, so it is held to 1e-5
of the logliks' size, not of its own.  Each member's island calls are
identical.
"""

import io

import jax
import numpy as np
import pytest
import torch

from cpgisland_tpu import family as JF
from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.serve.session import Session
from cpgisland_tpu_torch import family as TF
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq


@pytest.fixture(autouse=True)
def short_lanes(monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)


def _fasta(path, sizes, seed=5):
    """Records of background with CpG depleted and planted GC-rich islands."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i, n in enumerate(sizes):
            s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
            cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
            s[cg[rng.random(cg.size) < 0.75] + 1] = 0
            for a in range(400, n - 900, 4000):
                s[a : a + 800] = rng.choice(4, size=800, p=[0.15, 0.35, 0.35, 0.15])
            txt = "".join("ACGT"[x] for x in s)
            f.write(f">r{i} test\n" + "\n".join(txt[j : j + 60] for j in range(0, n, 60)) + "\n")
    return str(path)


def _pair(jm):
    """The port's member for a JAX member (the model carried as arrays)."""
    p = jm.params
    return TF.Member(jm.name, params_from_numpy(p.log_pi, p.log_A, p.log_B), jm.island_states,
                     jm.order)


def _random_member(name, K, S, seed, island_states):
    jp = JP.random_hmm(jax.random.PRNGKey(seed), K, S, partition=2)
    return JF.Member(name, jp, island_states, 1 if S == 4 else 2)


def _sessions(jmembers, engines):
    return {m.name: Session(m.params, engine=e, name=f"s{i}", private_breaker=True)
            for i, (m, e) in enumerate(zip(jmembers, engines)) if e is not None}


def _assert_reports_agree(got: str, want: str) -> None:
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if not a.startswith("# model "):
            assert a == b
            continue
        a, b = a.split(), b.split()
        assert a[:4] + a[7:] == b[:4] + b[7:]
        ll_a, ll_b = float(a[4]), float(b[4])
        np.testing.assert_allclose(ll_a, ll_b, rtol=1e-5)
        assert abs(float(a[6]) - float(b[6])) <= 1e-5 * abs(ll_b)


def _assert_results_agree(t_res, j_res) -> None:
    assert (t_res.n_symbols, t_res.n_records, t_res.member_names, t_res.baseline) == (
        j_res.n_symbols, j_res.n_records, j_res.member_names, j_res.baseline)
    for tr, jr in zip(t_res.records, j_res.records):
        np.testing.assert_array_equal(tr.winner, np.asarray(jr.winner))
        for tm, jm in zip(tr.members, jr.members):
            assert tm.calls.format_lines() == jm.calls.format_lines()
            np.testing.assert_allclose(tm.conf, np.asarray(jm.conf), rtol=0, atol=2e-5)


def _run_both(path, jmembers, t_kw, j_kw):
    t_buf, j_buf = io.StringIO(), io.StringIO()
    t_res = TPL.compare_file(path, [_pair(m) for m in jmembers], out=t_buf, device="cpu", **t_kw)
    j_res = JPL.compare_file(path, jmembers, out=j_buf, **j_kw)
    return t_buf.getvalue(), t_res, j_buf.getvalue(), j_res


def test_compare_default_cast_matches_jax(tmp_path):
    path = _fasta(tmp_path / "a.fa", (6000, 9000, 2500))
    jm = JF.default_members()
    got, t_res, want, j_res = _run_both(
        path, jm, {}, {"sessions": _sessions(jm, ["onehot", "pallas", None])})
    assert got.startswith("# cpgisland compare models=durbin8,two_state,null baseline=null\n")
    assert "r1|durbin8" in got or "r1|two_state" in got
    _assert_reports_agree(got, want)
    _assert_results_agree(t_res, j_res)


def test_compare_mixed_stacked_cast_matches_jax(tmp_path):
    """durbin8 + a random reduced member (a stacked group in the port) +
    two_state + null, with a threshold and a length filter."""
    path = _fasta(tmp_path / "b.fa", (7000, 3000), seed=9)
    jm = [JF.builtin_member("durbin8"), _random_member("rand", 8, 4, 3, (0, 1, 2, 3)),
          JF.builtin_member("two_state"), JF.builtin_member("null")]
    kw = {"threshold": 0.4, "min_len": 20}
    got, t_res, want, j_res = _run_both(
        path, jm, kw, {"sessions": _sessions(jm, ["onehot", "onehot", "pallas", None]), **kw})
    _assert_reports_agree(got, want)
    _assert_results_agree(t_res, j_res)


def test_compare_order2_cast_matches_jax(tmp_path):
    """dinuc_cpg over the pair recode, scored against null16."""
    path = _fasta(tmp_path / "c.fa", (2500, 1200), seed=13)
    jm = [JF.builtin_member("dinuc_cpg"), JF.builtin_member("null16")]
    got, t_res, want, j_res = _run_both(path, jm, {"engine": "onehot"}, {"engine": "onehot"})
    assert "baseline=null16" in got.splitlines()[0]
    _assert_reports_agree(got, want)
    _assert_results_agree(t_res, j_res)


def test_compare_record_matches_jax_on_a_stream():
    """family.compare_record on one stream, stacked, explicit baseline."""
    rng = np.random.default_rng(3)
    obs = rng.choice(4, size=5000, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    obs[1500:2600] = rng.choice(4, size=1100, p=[0.15, 0.35, 0.35, 0.15])
    jm = [JF.builtin_member("durbin8"), _random_member("rand", 8, 4, 7, (0, 1, 2, 3))]
    j = JF.compare_record(jm, obs, engine="onehot", baseline="rand", stacked=True)
    t = TF.compare_record([_pair(m) for m in jm], obs, baseline="rand", device="cpu")
    assert (t.record, t.n_symbols, t.baseline) == (j.record, j.n_symbols, j.baseline)
    np.testing.assert_array_equal(t.winner, np.asarray(j.winner))
    assert t.winner_calls.format_lines() == j.winner_calls.format_lines()
    for tm, jmr in zip(t.members, j.members):
        np.testing.assert_allclose(tm.loglik, jmr.loglik, rtol=1e-5)
        assert abs(tm.log_odds - jmr.log_odds) <= 1e-5 * abs(jmr.loglik)
        assert tm.calls.format_lines() == jmr.calls.format_lines()
        np.testing.assert_allclose(tm.conf, np.asarray(jmr.conf), rtol=0, atol=2e-5)
