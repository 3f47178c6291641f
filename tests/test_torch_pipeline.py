"""End to end: the PyTorch port's ``decode_file`` and CLI write island files
byte-identical to the JAX package's ``decode_file(engine="onehot",
island_engine="host")`` on a seeded FASTA.

The JAX side decodes clean records over its 8-device virtual CPU mesh and
the port over one device, so block geometries differ; paths are then equal
except at float32 near-ties (the engine's tie contract), which this fixture
does not contain — byte identity is asserted.  The CLI test decodes with
each package's own Durbin preset, whose float32 log tables differ by one
ulp in 3 of 64 entries (tests/test_torch_models.py states why); the
fixture has no tie at that scale either.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seq(rng, n, gc):
    return rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Five records of background with planted GC-rich segments, lowercase
    runs, N runs and a description on each header."""
    rng = np.random.default_rng(7)
    path = tmp_path_factory.mktemp("fa") / "genome.fa"
    with open(path, "w") as f:
        for r in range(5):
            s = _seq(rng, int(rng.integers(3000, 9000)), 0.41)
            s[800:1500] = _seq(rng, 700, 0.7)
            txt = "".join("ACGT"[x] for x in s)
            txt = txt[:300] + "NNNNNNNN" + txt[300:]
            f.write(f">rec{r} synthetic\n")
            for i in range(0, len(txt), 60):
                line = txt[i : i + 60]
                f.write((line.lower() if (i // 60) % 7 == 3 else line) + "\n")
    return str(path)


def _jax_model():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


@pytest.mark.parametrize("compat,small_max", [(True, 4 << 20), (False, 4 << 20), (False, 2000)])
def test_decode_file_matches_jax(fasta, monkeypatch, compat, small_max):
    """compat: 4 Ki chunks in flat batches; clean: the scaffold batch route
    (small_max = 4 Mi) and the whole-record route (small_max = 2000)."""
    monkeypatch.setattr(JPL, "SMALL_RECORD_MAX", small_max)
    monkeypatch.setattr(TPL, "SMALL_RECORD_MAX", small_max)
    jp, tp = _jax_model()
    want, got = io.StringIO(), io.StringIO()
    rj = JPL.decode_file(fasta, jp, islands_out=want, compat=compat, chunk_size=4096,
                         engine="onehot", island_engine="host")
    rt = TPL.decode_file(fasta, tp, islands_out=got, compat=compat, chunk_size=4096,
                         device="cpu")
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("\n") >= 3  # the planted islands are called
    assert (rt.n_symbols, rt.n_chunks) == (rj.n_symbols, rj.n_chunks)
    assert set(rt.phases) == {"encode", "decode", "islands"}


@pytest.mark.parametrize("clean", [True, False])
def test_cli_matches_jax(fasta, tmp_path, clean):
    out = tmp_path / "islands.txt"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "cpgisland_tpu_torch", "decode", fasta,
           "--islands-out", str(out), "--device", "cpu"]
    if clean:
        cmd += ["--clean", "--min-len", "100"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "islands" in proc.stdout
    want = io.StringIO()
    JPL.decode_file(fasta, JP.durbin_cpg8(), islands_out=want, compat=not clean,
                    min_len=100 if clean else None, engine="onehot", island_engine="host")
    assert out.read_text() == want.getvalue()


def test_default_device_needs_cuda(fasta, monkeypatch):
    """Entry points run on the card by default and never fall back to the
    CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _jax_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPL.decode_file(fasta, tp, compat=False)


def test_unported_routes_raise(fasta, tmp_path, monkeypatch):
    """Routes that once raised: records past the span now decode span by
    span to the one-pass result, and the state-path dump is written; mask
    in compat mode still raises."""
    _, tp = _jax_model()
    monkeypatch.setattr(TPL, "SMALL_RECORD_MAX", 4)
    one, spanned = io.StringIO(), io.StringIO()
    TPL.decode_file(fasta, tp, islands_out=one, compat=False, device="cpu")
    res = TPL.decode_file(fasta, tp, islands_out=spanned, compat=False, span=4000,
                          state_path_out=str(tmp_path / "p.npy"), device="cpu")
    assert res.n_chunks > 5 and one.getvalue() == spanned.getvalue()  # 5 records
    assert np.load(tmp_path / "p.npy").shape == (res.n_symbols,)
    with pytest.raises(ValueError):
        TPL.decode_file(fasta, tp, compat=True, invalid_symbols="mask", device="cpu")
    # A lone record whose first position is masked decodes through the dense
    # engine (the pad-first demotion) instead of raising.
    p = tmp_path / "padfirst.fa"
    p.write_text(">r\nNNACGTACGTACGT\n")
    res = TPL.decode_file(str(p), tp, compat=False, invalid_symbols="mask", device="cpu")
    assert res.n_symbols == 14
