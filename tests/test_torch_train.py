"""Baum-Welch training in the PyTorch port vs the JAX package, on the CPU.

The port trains through the plain versions of its E-step kernels here; the
JAX package trains through its onehot engine, whose off-TPU route is the
XLA twins (``fit(engine="onehot")``; its fused EM loop has the host loop's
semantics).  The two hold each other within the tolerances the JAX
package's own parity tests pin: logliks within rtol 1e-5 and probabilities
within atol 1e-5, with the same iteration count.  They are not bitwise
equal, because XLA:CPU contracts multiply-adds into FMAs and its float32
exp/log are not correctly rounded (see tests/test_torch_fb_onehot.py).
Chunks are 4 Ki symbols: a 65,536-step plain chain costs seconds a pass
on the CPU.  The six-positional CLI runs at the reference's own chunk
sizes on a fixture of just over 1 Mi symbols (compat mode decodes nothing
below one 1 Mi chunk); there the JAX CLI trains through its dense "xla"
engine, which the reduced sums equal up to rounding.
"""

import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops.forward_backward import SuffStats as JStats
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import cli as TCLI
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import HmmParams, load_text, params_from_numpy
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4096


def _both():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _probs(params):
    return [np.asarray(x, np.float64) for x in (params.pi, params.A, params.B)]


def _same_model(jparams, tparams, atol=1e-5):
    for j, t in zip(_probs(jparams), _probs(tparams)):
        np.testing.assert_allclose(t, j, atol=atol)
        assert np.array_equal(t == 0, j == 0)  # structural zeros stay exact


def _fits_agree(jr, tr):
    assert tr.iterations == jr.iterations and tr.converged == jr.converged
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    np.testing.assert_allclose(tr.deltas, jr.deltas, atol=1e-5)
    _same_model(jr.params, tr.params)


def _seq(rng, n, gc):
    return rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])


def _write_fasta(path, records, rng):
    with open(path, "w") as f:
        for name, s in records:
            txt = "".join("ACGT"[x] for x in s)
            txt = txt[:300] + "NNNNNNNN" + txt[300:]
            f.write(f">{name} synthetic\n")
            for i in range(0, len(txt), 60):
                line = txt[i : i + 60]
                f.write((line.lower() if (i // 60) % 7 == 3 else line) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Three records of background with planted GC-rich segments."""
    rng = np.random.default_rng(21)
    recs = []
    for r in range(3):
        s = _seq(rng, int(rng.integers(5000, 9000)), 0.41)
        s[1000:2200] = _seq(rng, 1200, 0.7)
        recs.append((f"rec{r}", s))
    return _write_fasta(tmp_path_factory.mktemp("fa") / "train.fa", recs, rng)


# -- model core and M-step -----------------------------------------------------


def test_mstep_and_delta_match_jax(rng):
    """The same counts through both M-steps (zero rows keep the previous
    distribution), and the convergence metric."""
    jp, tp = _both()
    init = rng.random(8).astype(np.float32) * 5
    trans = rng.random((8, 8)).astype(np.float32) * 100
    trans[3] = 0.0  # a row with no counts
    emit = (rng.random((8, 4)) * 50 * (np.asarray(jp.log_B) > -1e29)).astype(np.float32)
    js = JStats(init=jnp.asarray(init), trans=jnp.asarray(trans), emit=jnp.asarray(emit),
                loglik=jnp.float32(-1.0), n_seqs=jnp.int32(3))
    ts = SuffStats(init=torch.from_numpy(init), trans=torch.from_numpy(trans),
                   emit=torch.from_numpy(emit), loglik=torch.tensor(-1.0),
                   n_seqs=torch.tensor(3))
    jn, jd = JBW.em_update(jp, js)
    tn, td = TBW.em_update(tp, ts)
    _same_model(jn, tn, atol=1e-6)
    assert float(td) == pytest.approx(float(jd), abs=1e-6)
    np.testing.assert_array_equal(_probs(tn)[1][3], _probs(tp)[1][3])


def test_resolve_fb_engine_and_backends():
    jp, tp = _both()
    assert TBE.resolve_fb_engine("auto", tp, "rescaled") == "onehot"
    assert TBE.resolve_fb_engine("onehot", tp, "rescaled") == "onehot"
    dense = HmmParams.from_probs(np.full(2, 0.5), np.full((2, 2), 0.5), np.full((2, 4), 0.25))
    assert TBE.resolve_fb_engine("auto", dense, "rescaled") == "pallas"
    assert TBE.resolve_fb_engine("pallas", tp, "rescaled") == "pallas"
    big = HmmParams.from_probs(np.full(9, 1 / 9), np.full((9, 9), 1 / 9), np.full((9, 4), 0.25))
    # The generic engine: "auto" takes it outside both kernel domains and
    # for the log numerics, as the JAX router does on its TPU.
    for engine, params, mode in (("auto", big, "rescaled"), ("xla", tp, "rescaled"),
                                 ("auto", tp, "log")):
        assert TBE.resolve_fb_engine(engine, params, mode) == "xla"
    with pytest.raises(ValueError, match="rescaled numerics only"):
        TBE.resolve_fb_engine("onehot", tp, "log")
    with pytest.raises(ValueError):
        TBE.resolve_fb_engine("bogus", tp, "rescaled")
    assert isinstance(TBE.get_backend("local"), TBE.LocalBackend)
    # The whole-sequence backends and the chunk-sharded mesh backend are ported.
    assert isinstance(TBE.get_backend("seq"), TBE.SeqBackend)
    assert isinstance(TBE.get_backend("seq2d"), TBE.Seq2DBackend)
    assert isinstance(TBE.get_backend("spmd"), TBE.SpmdBackend)


# -- fit -------------------------------------------------------------------------


def _chunked(rng, N=6, T=CHUNK):
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    a, m = T // 8, T // 5
    for i in range(N):  # a GC-rich stretch per chunk
        chunks[i, a : a + m] = _seq(rng, m, 0.75)
    lengths = np.full(N, T, np.int32)
    lengths[-1], lengths[2] = T // 3, 0
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    total = int(lengths.sum())
    return (JCH.Chunked(chunks=chunks, lengths=lengths, total=total),
            TCH.Chunked(chunks=chunks, lengths=lengths, total=total))


def test_fit_trajectory_matches_jax(rng):
    """A 10-iteration trajectory (convergence 0: no early stop)."""
    jp, tp = _both()
    jc, tc = _chunked(rng)
    jr = JBW.fit(jp, jc, num_iters=10, convergence=0.0, engine="onehot")
    tr = TBW.fit(tp, tc, num_iters=10, convergence=0.0)
    assert tr.iterations == 10
    _fits_agree(jr, tr)
    assert all(b >= a for a, b in zip(tr.logliks, tr.logliks[1:]))  # EM ascends
    assert set(tr.phases) == {"prepare", "estep", "mstep", "em"}


def test_fit_refuses_unported_options(rng):
    _, tp = _both()
    _, tc = _chunked(rng, N=3, T=64)
    for kw in ({"checkpoint_dir": "x"}, {"callback": print},
               {"fallback_backend": TBE.LocalBackend()}, {"start_iteration": 2}):
        with pytest.raises(NotImplementedError):
            TBW.fit(tp, tc, num_iters=1, **kw)
    with pytest.raises(ValueError):
        TBW.fit(tp, tc, num_iters=1, fuse="sometimes")
    # The device loop (fuse=True) is ported: it runs, as "off" does.
    assert TBW.fit(tp, tc, num_iters=1, fuse=True).iterations == 1
    assert TBW.fit(tp, tc, num_iters=1, fuse="off").iterations == 1


# -- train_file, run, CLI ------------------------------------------------------------


@pytest.mark.parametrize("compat", [True, False])
def test_train_file_matches_jax(fasta, tmp_path, compat):
    """compat and clean framing at 4 Ki chunks, the reference's defaults
    otherwise (convergence 0.005, at most 10 iterations); the model dumps
    parse to the same model."""
    jm, tm = tmp_path / "j.txt", tmp_path / "t.txt"
    jr = JPL.train_file(fasta, compat=compat, chunk_size=CHUNK, engine="onehot",
                        model_out=str(jm))
    tr = TPL.train_file(fasta, compat=compat, chunk_size=CHUNK, model_out=str(tm),
                        device="cpu")
    _fits_agree(jr, tr)
    assert tr.converged and 1 < tr.iterations < 10
    _same_model(load_text(str(jm)), load_text(str(tm)))
    assert set(tr.phases) == {"encode", "prepare", "estep", "mstep", "em"}


def test_compat_trains_nothing_below_one_chunk(tmp_path):
    """compat drops the remainder chunk: a file shorter than one chunk
    gives zero counts, and EM stops at once with the model unchanged."""
    p = tmp_path / "tiny.fa"
    p.write_text(">x\n" + "ACGTTGCA" * 125 + "\n")
    jr = JPL.train_file(str(p), chunk_size=CHUNK, engine="onehot")
    tr = TPL.train_file(str(p), chunk_size=CHUNK, device="cpu")
    _fits_agree(jr, tr)
    assert tr.logliks == [0.0] and tr.converged
    _same_model(JP.durbin_cpg8(), tr.params, atol=1e-7)


def test_entry_points_default_to_cuda(fasta, monkeypatch, tmp_path):
    """train_file, run and the CLI run on the card by default and never
    fall back to the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPL.train_file(fasta)
    out = [str(tmp_path / x) for x in ("i.txt", "m.txt")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPL.run(fasta, fasta, *out)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCLI.main([fasta, fasta, *out, "0.005", "2"])
    # A symbol cache is FASTA-aware: compat mode (the default) refuses it.
    with pytest.raises(ValueError, match="FASTA-aware"):
        TPL.train_file(fasta, symbol_cache=str(tmp_path / "c"), device="cpu")
    with pytest.raises(ValueError):
        TPL.train_file(fasta, invalid_symbols="mask", device="cpu")  # compat


def test_cli_train_and_run_subcommands(fasta, tmp_path, capsys):
    """The subcommands drive the same pipeline calls; --device may stand
    anywhere."""
    m1, m2 = tmp_path / "cli.txt", tmp_path / "api.txt"
    assert TCLI.main(["--device", "cpu", "train", fasta, "--model-out", str(m1), "--clean",
                      "--iters", "1"]) == 0
    assert "trained: iters=1" in capsys.readouterr().out
    TPL.train_file(fasta, compat=False, num_iters=1, model_out=str(m2), device="cpu")
    assert m1.read_text() == m2.read_text()
    isl, mod = tmp_path / "i.txt", tmp_path / "m.txt"
    assert TCLI.main(["run", fasta, fasta, "--islands-out", str(isl), "--model-out", str(mod),
                      "--clean", "--iters", "1", "--device=cpu"]) == 0
    want = io.StringIO()
    TPL.decode_file(fasta, load_text(str(m2)), islands_out=want, compat=False, device="cpu")
    assert isl.read_text() == want.getvalue() and mod.read_text() == m2.read_text()
    with pytest.raises(SystemExit):
        TCLI.main(["train", fasta, "--model-out", str(m1), "--device", "tpu"])


@pytest.fixture(scope="module")
def mib_fasta(tmp_path_factory):
    """Just over 1 Mi bases in one record: GC 0.41 background with planted
    islands of 0.6-2.5 kb."""
    rng = np.random.default_rng(11)
    n = (1 << 20) + 70_000
    s = _seq(rng, n, 0.41)
    for a in rng.integers(0, n - 3000, size=n // 40_000):
        m = int(rng.integers(600, 2500))
        s[a : a + m] = _seq(rng, m, 0.65)
    path = tmp_path_factory.mktemp("mib") / "chr.fa"
    txt = "".join("ACGT"[x] for x in s)
    with open(path, "w") as f:
        f.write(">chrT synthetic\n")
        for i in range(0, n, 60):
            f.write(txt[i : i + 60] + "\n")
    return str(path)


def test_six_positional_cli_matches_jax(mib_fasta, tmp_path):
    """``TRAIN TEST ISLANDS MODEL 0.005 2`` through both CLIs (run side by
    side): byte-identical island files, model dumps that parse to the same
    model; and the port decoding the JAX-trained model gives the JAX island
    file byte for byte."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = {k: [str(tmp_path / f"{k}.{x}") for x in ("islands", "model")]
           for k in ("jax", "torch")}
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, "-m", "cpgisland_tpu", "--platform", "cpu", mib_fasta, mib_fasta,
             *out["jax"], "0.005", "2"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "torch": subprocess.Popen(
            [sys.executable, "-m", "cpgisland_tpu_torch", mib_fasta, mib_fasta,
             *out["torch"], "0.005", "2", "--device", "cpu"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name}: {err[-2000:]}"
    (j_isl, j_mod), (t_isl, t_mod) = out["jax"], out["torch"]
    with open(j_isl) as f:
        want = f.read()
    with open(t_isl) as f:
        assert f.read() == want
    assert want.count("\n") >= 10
    _same_model(load_text(j_mod), load_text(t_mod))
    got = io.StringIO()
    TPL.decode_file(mib_fasta, load_text(j_mod), islands_out=got, compat=True, device="cpu")
    assert got.getvalue() == want
