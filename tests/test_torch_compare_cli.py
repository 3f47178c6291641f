"""The port's ``compare`` on its own: the stacked and sequential arms give
byte-identical reports, the stacked dispatch takes exactly the grouped
members and raises on failure, dinuc_cpg is the flagship's pair lift, and
the CLI subcommand's forms and usage errors.
"""

import io
import math

import numpy as np
import pytest
import torch

from cpgisland_tpu_torch import cli
from cpgisland_tpu_torch import family as TF
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.family import stacked as stacked_mod
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import dump_text
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.parallel import posterior as TPO


@pytest.fixture(autouse=True)
def short_lanes(monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)


def _sequence(rng, n):
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
    for a in range(300, n - 900, 3000):
        s[a : a + 700] = rng.choice(4, size=700, p=[0.15, 0.35, 0.35, 0.15])
    return s.astype(np.uint8)


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(17)
    path = tmp_path / "x.fa"
    with open(path, "w") as f:
        for i, n in enumerate((5000, 2000, 3500)):
            f.write(f">q{i}\n" + "".join("ACGT"[x] for x in _sequence(rng, n)) + "\n")
    return str(path)


def _rand(name, K, S, seed, order):
    p = presets.random_hmm(torch.Generator().manual_seed(seed), K, S, partition=2)
    return TF.Member(name, p, tuple(range(S)), order)


def _report(path, members, **kw):
    buf = io.StringIO()
    TPL.compare_file(path, members, out=buf, device="cpu", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("cast", ["mixed", "order2"])
def test_stacked_and_sequential_reports_are_byte_identical(fasta, cast, monkeypatch):
    if cast == "mixed":
        members = [TF.builtin_member("durbin8"), _rand("rand", 8, 4, 1, 1),
                   TF.builtin_member("two_state"), TF.builtin_member("null")]
    else:
        members = [TF.builtin_member("dinuc_cpg"), _rand("rand32", 32, 16, 2, 2),
                   TF.builtin_member("null16")]
    calls = []
    real = stacked_mod.stacked_posterior_records
    monkeypatch.setattr(stacked_mod, "stacked_posterior_records",
                        lambda ms, *a, **k: calls.append([m.name for m in ms]) or real(ms, *a, **k))
    stacked = _report(fasta, members)
    grouped = calls[:]
    calls.clear()
    sequential = _report(fasta, members, stacked=False)
    assert stacked == sequential
    assert calls == []
    # One stacked dispatch per record, of exactly the two reduced members.
    assert grouped == [[members[0].name, members[1].name]] * 3


def test_stacked_dispatch_routes_by_resolved_engine(fasta, monkeypatch):
    """engine="pallas" sends the flagship to the dense engine: no group.  A
    singleton reduced member stays on the sequential arm."""
    calls = []
    monkeypatch.setattr(stacked_mod, "stacked_posterior_records",
                        lambda *a, **k: calls.append(1))
    members = [TF.builtin_member("durbin8"), _rand("rand", 8, 4, 1, 1), TF.builtin_member("null")]
    _report(fasta, members, engine="pallas")
    _report(fasta, TF.default_members())
    assert calls == []


def test_a_stacked_failure_raises(fasta, monkeypatch):
    """No resilience layer: nothing falls back to the sequential arm."""
    def boom(*a, **k):
        raise RuntimeError("stacked dispatch failed")

    monkeypatch.setattr(stacked_mod, "stacked_posterior_records", boom)
    members = [TF.builtin_member("durbin8"), _rand("rand", 8, 4, 1, 1)]
    with pytest.raises(RuntimeError, match="stacked dispatch failed"):
        _report(fasta, members)


def test_dinuc_pair_lift_equals_flagship():
    """dinuc_cpg over the pair recode is the exact pair-state lifting of the
    flagship: logliks differ by log 4 and the confidence tracks agree."""
    obs = _sequence(np.random.default_rng(7), 12_000)
    rc = TF.compare_record([TF.builtin_member("durbin8"), TF.builtin_member("dinuc_cpg")], obs,
                           device="cpu")
    flag, dinuc = rc.members
    assert abs((flag.loglik - math.log(4.0)) - dinuc.loglik) <= 1e-5 * abs(flag.loglik)
    assert float(np.abs(flag.conf.astype(np.float64) - dinuc.conf).max()) < 1e-3


def test_compare_file_options_not_ported_raise(fasta, tmp_path):
    for kw, item in (({"metrics": object()}, "A12"),
                     ({"timer": object()}, "A12"), ({"sessions": {}}, "A13")):
        with pytest.raises(NotImplementedError, match=item):
            TPL.compare_file(fasta, out=io.StringIO(), device="cpu", **kw)
    # Symbol caches are ported (A1): the cached report is the uncached one.
    members = TF.default_members()
    assert _report(fasta, members, symbol_cache=str(tmp_path / "c")) == _report(fasta, members)
    assert (tmp_path / "c.meta.npz").exists()


def test_a_wide_dense_member_raises_naming_a2(fasta):
    """A K = 12 member outside both kernel domains (it raised, naming
    ROADMAP A2, before the lane path was ported) now scores and calls on
    the generic "xla" engine: its confidence is the lane-path posterior
    of each record, and the report carries its model line."""
    p = presets.random_hmm(torch.Generator().manual_seed(0), 12, 4)
    members = [TF.builtin_member("durbin8"), TF.Member("wide", p, (0,), 1)]
    res = TPL.compare_file(fasta, members, out=io.StringIO(), device="cpu")
    recs = [r for r in TPL.codec.iter_fasta_records(fasta)]
    for rc, (_, sym) in zip(res.records, recs):
        conf, _ = TPO.posterior_sharded(p, sym, (0,), engine="xla")
        np.testing.assert_allclose(rc.member("wide").conf, conf, atol=2e-5)
        assert np.isfinite(rc.member("wide").loglik)
    assert _report(fasta, members).count("# model wide loglik") == 3


def test_compare_result_carries_phases(fasta):
    res = TPL.compare_file(fasta, device="cpu")
    assert (res.n_records, res.member_names, res.baseline) == (
        3, ["durbin8", "two_state", "null"], "null")
    assert set(res.phases) == {"encode", "score", "posterior", "islands", "winner"}
    assert res.n_symbols == sum(rc.n_symbols for rc in res.records) == 10_500


# -- the CLI subcommand


def _cli(argv):
    return cli.main(argv + ["--device", "cpu"])


def test_cli_compare_default_cast_writes_the_report(fasta, tmp_path, capsys):
    out = tmp_path / "r.txt"
    assert _cli(["compare", fasta, "--out", str(out)]) == 0
    assert "compared 3 models over 10500 symbols in 3 records; baseline null" in \
        capsys.readouterr().out
    assert out.read_text() == _report(fasta, TF.default_members())


def test_cli_compare_model_files_baseline_threshold_no_stacked(fasta, tmp_path):
    model = tmp_path / "mine.txt"
    dump_text(presets.durbin_cpg8(), str(model))
    outs = []
    for extra in ([], ["--no-stacked"]):
        out = tmp_path / f"r{len(outs)}.txt"
        assert _cli(["compare", fasta, "--models", f"durbin8,mine={model},two_state,null",
                     "--baseline", "two_state", "--threshold", "0.6", "--min-len", "30",
                     "--out", str(out)] + extra) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    members = [TF.builtin_member("durbin8"), TF.member_from_params("mine", presets.durbin_cpg8()),
               TF.builtin_member("two_state"), TF.builtin_member("null")]
    assert outs[0] == _report(fasta, members, baseline="two_state", threshold=0.6, min_len=30)
    assert outs[0].startswith("# cpgisland compare models=durbin8,mine,two_state,null "
                              "baseline=two_state\n")


def test_cli_compare_order2_members(fasta, tmp_path):
    out = tmp_path / "r.txt"
    assert _cli(["compare", fasta, "--models", "dinuc_cpg,null16", "--out", str(out)]) == 0
    assert out.read_text() == _report(fasta, [TF.builtin_member("dinuc_cpg"),
                                              TF.builtin_member("null16")])


@pytest.mark.parametrize("models, extra, msg", [
    ("durbin8,durbin8", [], "duplicate member name"),
    (",", [], "named no members"),
    ("durbin8,null", ["--baseline", "two_state"], "baseline"),
    ("durbin8,nope", [], "unknown family member"),
])
def test_cli_compare_usage_errors(fasta, tmp_path, capsys, models, extra, msg):
    with pytest.raises((SystemExit, ValueError)) as e:
        _cli(["compare", fasta, "--models", models, "--out", str(tmp_path / "r.txt")] + extra)
    if isinstance(e.value, SystemExit):
        assert e.value.code == 2
        assert msg in capsys.readouterr().err
    else:
        assert msg in str(e.value)
