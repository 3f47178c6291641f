"""End to end: the PyTorch port's ``posterior_file`` and CLI ``posterior``
vs the JAX package's ``posterior_file(engine="onehot",
island_engine="host")`` on a seeded FASTA with scaffolds and one record
longer than the test span.

The JAX side runs clean records over its 8-device virtual CPU mesh and the
port over one device, with other lane geometries (the port's lanes are
shortened here to keep the plain chains cheap): confidence is held within
atol 2e-5 (the JAX package's own posterior parity pin), the mean
confidence within 1e-6, and island files byte for byte (the fixture has no
near-tie in the MPM path).
"""

import io

import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu_torch import cli
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq

SPAN = 1 << 14


def _seq(rng, n):
    """Background at GC 0.41 with CpG depleted and GC-rich stretches."""
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    s[cg[rng.random(cg.size) < 0.75] + 1] = 0
    for a in range(400, n - 900, 5000):
        s[a : a + 800] = rng.choice(4, size=800, p=[0.15, 0.35, 0.35, 0.15])
    return s


def _write(path, records):
    with open(path, "w") as f:
        for name, s in records:
            txt = "".join("ACGT"[x] for x in s)
            f.write(f">{name} synthetic\n")
            for i in range(0, len(txt), 60):
                line = txt[i : i + 60]
                f.write((line.lower() if (i // 60) % 9 == 4 else line) + "\n")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A 21 kb record (two spans of SPAN) between scaffolds of 1-6 kb."""
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("fa") / "genome.fa"
    sizes = [2500, 21000, 5200, 1300, 6000]
    _write(path, [(f"rec{r}", _seq(rng, n)) for r, n in enumerate(sizes)])
    return str(path)


@pytest.fixture
def short_lanes(monkeypatch):
    # Plain chains are Python loops over a lane's steps: keep lanes short.
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)


def _models():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


@pytest.mark.parametrize("span", [SPAN, TPL.POSTERIOR_SPAN])
def test_posterior_file_matches_jax(fasta, tmp_path, short_lanes, span):
    """span = 16 Ki: the 21 kb record runs as two threaded spans and the
    scaffolds batch; the default span: the record batches with them."""
    jp, tp = _models()
    want, got = io.StringIO(), io.StringIO()
    rj = JPL.posterior_file(fasta, jp, islands_out=want, confidence_out=str(tmp_path / "j.npy"),
                            span=span, engine="onehot", island_engine="host")
    rt = TPL.posterior_file(fasta, tp, islands_out=got, confidence_out=str(tmp_path / "t.npy"),
                            mpm_path_out=str(tmp_path / "p.npy"), span=span, device="cpu")
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("\n") >= 3
    cj, ct = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert ct.dtype == np.float32 and ct.shape == cj.shape == (rt.n_symbols,)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=2e-5)
    assert abs(rt.mean_island_confidence - rj.mean_island_confidence) <= 1e-6
    assert (rt.n_symbols, rt.n_records) == (rj.n_symbols, rj.n_records)
    path = np.load(tmp_path / "p.npy")
    assert path.dtype == np.int8 and path.shape == ct.shape
    assert set(np.unique(path)) <= set(range(8))
    want_phases = {"encode", "posterior", "islands"} | ({"span-totals"} if span == SPAN else set())
    assert set(rt.phases) == want_phases


def test_spans_agree_with_one_pass(fasta, tmp_path, short_lanes):
    """Exact threading: the span-wise run gives the single-pass run's islands
    and, within float32 rounding, its confidence."""
    _, tp = _models()
    outs = {}
    for span in (SPAN, 1 << 15):
        buf = io.StringIO()
        conf = str(tmp_path / f"c{span}.npy")
        TPL.posterior_file(fasta, tp, islands_out=buf, confidence_out=conf, span=span,
                           device="cpu")
        outs[span] = (buf.getvalue(), np.load(conf))
    assert outs[SPAN][0] == outs[1 << 15][0]
    np.testing.assert_allclose(outs[SPAN][1], outs[1 << 15][1], rtol=0, atol=2e-6)


def test_single_record_bare_format_and_island_states(tmp_path, short_lanes):
    """One record: the reference's bare five columns.  Named island states
    call islands from the observations' composition (the same calls here,
    since the flagship's island states encode the bases)."""
    rng = np.random.default_rng(4)
    fa = tmp_path / "one.fa"
    _write(fa, [("chrX", _seq(rng, 9000))])
    jp, tp = _models()
    outs = {}
    for states in (None, (0, 1, 2, 3)):
        buf = io.StringIO()
        TPL.posterior_file(str(fa), tp, islands_out=buf, island_states=states, device="cpu")
        outs[states] = buf.getvalue()
    want = io.StringIO()
    JPL.posterior_file(str(fa), jp, islands_out=want, engine="onehot", island_engine="host")
    assert outs[None] == want.getvalue() == outs[(0, 1, 2, 3)]
    assert outs[None] and len(outs[None].splitlines()[0].split()) == 5


def test_cli_posterior(fasta, tmp_path, short_lanes, capsys):
    out, conf = tmp_path / "islands.txt", tmp_path / "conf.npy"
    rc = cli.main(["posterior", fasta, "--islands-out", str(out), "--confidence-out",
                   str(conf), "--min-len", "100", "--device", "cpu"])
    assert rc == 0
    assert "mean island confidence" in capsys.readouterr().out
    want = io.StringIO()
    JPL.posterior_file(fasta, JP.durbin_cpg8(), islands_out=want, min_len=100,
                       engine="onehot", island_engine="host")
    assert out.read_text() == want.getvalue() and want.getvalue()
    assert np.load(conf).shape == (TPL.codec.encode_file(fasta, skip_headers=True).size,)
    with pytest.raises(SystemExit):
        cli.main(["posterior", fasta, "--device", "cpu"])  # nothing to do


def test_posterior_unported_and_bad_options(fasta, monkeypatch, tmp_path, short_lanes):
    _, tp = _models()
    kw = dict(islands_out=io.StringIO(), device="cpu")
    # Symbol caches are ported: a cached run writes the uncached run's islands.
    want, got = io.StringIO(), io.StringIO()
    TPL.posterior_file(fasta, tp, islands_out=want, device="cpu")
    TPL.posterior_file(fasta, tp, islands_out=got, symbol_cache=str(tmp_path / "c"),
                       device="cpu")
    assert got.getvalue() == want.getvalue() and (tmp_path / "c.symbols.npy").exists()
    for opt, val in (("prefetch", 1), ("resume", True),
                     ("manifest_path", "m.jsonl"), ("integrity_check", True),
                     ("metrics", object()), ("session", object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TPL.posterior_file(fasta, tp, **kw, **{opt: val})
    # The device island engine is ported; it refuses a run that dumps the
    # MPM path, as in the JAX package.
    with pytest.raises(ValueError, match="no mpm_path_out"):
        TPL.posterior_file(fasta, tp, island_engine="device", mpm_path_out="p.npy", **kw)
    with pytest.raises(ValueError, match="island_engine"):
        TPL.posterior_file(fasta, tp, island_engine="gpu", **kw)
    with pytest.raises(ValueError, match="nothing to do"):
        TPL.posterior_file(fasta, tp, device="cpu")
    # engine="xla" (it raised before the lane path was ported) writes the
    # kernels' island file.
    xla = io.StringIO()
    TPL.posterior_file(fasta, tp, islands_out=xla, engine="xla", device="cpu")
    assert xla.getvalue() == want.getvalue()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPL.posterior_file(fasta, tp, islands_out=io.StringIO())
