"""Training on the dense forward-backward engine: the PyTorch port's
``train_file``, ``fit`` and CLI ``train`` for the two_state preset and a
random dense model vs the JAX package, on the CPU; and the engine routing
of the train and posterior routers (soft decoding end to end:
tests/test_torch_dense_fb_posterior.py).

The port trains through the dense kernels' plain versions (B16, B18,
B20); the JAX side through its "xla" engine (the routing its CPU takes).
Held: logliks within rtol 1e-5, probabilities within atol 1e-5 with the
same structural zeros.  Chunks are 4 Ki symbols or less: the plain chains
are Python loops over the steps.
"""

import numpy as np
import pytest

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import cli
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import HmmParams, load_text, params_from_numpy
from cpgisland_tpu_torch.parallel import posterior as TPO
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

CHUNK = 4096


def _seq(rng, n):
    """AT-leaning background with GC-rich stretches every 5 kb."""
    s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
    for a in range(400, n - 1500, 5000):
        s[a : a + 1400] = rng.choice(4, size=1400, p=[0.14, 0.36, 0.36, 0.14])
    return s


def _write(path, records):
    with open(path, "w") as f:
        for name, s in records:
            txt = "".join("ACGT"[x] for x in s)
            f.write(f">{name} synthetic\n")
            for i in range(0, len(txt), 60):
                f.write(txt[i : i + 60] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Records of 1.3-12 kb, 27 kb in all."""
    rng = np.random.default_rng(5)
    sizes = [2500, 12000, 5200, 1300, 6000]
    return _write(tmp_path_factory.mktemp("fa") / "g.fa",
                  [(f"rec{r}", _seq(rng, n)) for r, n in enumerate(sizes)])


def _two_state():
    jp = JP.two_state_cpg()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _probs(params):
    return [np.asarray(x, np.float64) for x in (params.pi, params.A, params.B)]


def _same_model(jparams, tparams, atol=1e-5):
    for j, t in zip(_probs(jparams), _probs(tparams)):
        np.testing.assert_allclose(t, j, atol=atol)
        assert np.array_equal(t == 0, j == 0)


# -- training ------------------------------------------------------------------------


@pytest.mark.parametrize("compat", [True, False])
def test_dense_train_file_matches_jax(fasta, tmp_path, compat):
    """two_state through the dense E-step, compat and clean framing at 4 Ki
    chunks: the same trajectory and model dumps that parse to the same
    model as the JAX package's ``train_file(engine="xla")``."""
    jp, tp = _two_state()
    jm, tm = tmp_path / "j.txt", tmp_path / "t.txt"
    jr = JPL.train_file(fasta, params=jp, compat=compat, chunk_size=CHUNK, engine="xla",
                        model_out=str(jm))
    tr = TPL.train_file(fasta, params=tp, compat=compat, chunk_size=CHUNK,
                        model_out=str(tm), device="cpu")
    assert tr.iterations == jr.iterations and tr.converged == jr.converged
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    _same_model(load_text(str(jm)), load_text(str(tm)))
    assert tr.iterations > 1 and all(b >= a for a, b in zip(tr.logliks, tr.logliks[1:]))


def test_dense_fit_trajectory_matches_jax(rng):
    """Ten iterations (convergence 0) of a random 5-state model over 3
    symbols with a structural zero in A, on ragged chunks."""
    K, S, N, T = 5, 3, 5, 1024
    A = rng.dirichlet(np.ones(K), size=K) + np.eye(K) * 3
    A[1, 3] = 0.0
    A /= A.sum(1, keepdims=True)
    jp = JHmm.from_probs(rng.dirichlet(np.ones(K)), A, rng.dirichlet(np.ones(S), size=K))
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    chunks = rng.integers(0, S, size=(N, T)).astype(np.uint8)
    chunks[:, 300:900] = rng.integers(1, S, size=(N, 600))
    lengths = np.array([T, T, 700, 0, 77], np.int32)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    total = int(lengths.sum())
    jr = JBW.fit(jp, JCH.Chunked(chunks=chunks, lengths=lengths, total=total), num_iters=10,
                 convergence=0.0, engine="xla")
    tr = TBW.fit(tp, TCH.Chunked(chunks=chunks, lengths=lengths, total=total), num_iters=10,
                 convergence=0.0)
    assert tr.iterations == jr.iterations == 10
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    np.testing.assert_allclose(tr.deltas, jr.deltas, atol=1e-5)
    _same_model(jr.params, tr.params)


def test_flagship_dense_engine_trains_as_reduced(rng):
    """The flagship's tables through engine="pallas" follow the reduced
    engine's trajectory."""
    N, T = 4, 1024
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    chunks[:, 200:600] = rng.choice(4, size=(N, 400), p=[0.15, 0.35, 0.35, 0.15])
    lengths = np.array([T, 900, 0, 33], np.int32)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    data = TCH.Chunked(chunks=chunks, lengths=lengths, total=int(lengths.sum()))
    fits = [TBW.fit(TP.durbin_cpg8(), data, num_iters=3, convergence=0.0, engine=e)
            for e in ("pallas", "onehot")]
    np.testing.assert_allclose(fits[0].logliks, fits[1].logliks, rtol=1e-5)
    for a, b in zip(_probs(fits[0].params), _probs(fits[1].params)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_backend_resolves_once_and_dispatches(rng):
    _, tp = _two_state()
    be = TBE.LocalBackend()
    chunks, lengths = be.place(TCH.frame(rng.integers(0, 4, 300).astype(np.uint8), 128), "cpu")
    with pytest.raises(RuntimeError, match="prepare_streams"):
        be(tp, chunks, lengths, None)
    prep = be.prepare_streams(tp, chunks, lengths)
    assert be.resolved == "pallas" and not prep.onehot
    stats = be(tp, chunks, lengths, prep)
    assert int(stats.n_seqs) == 3 and float(stats.emit.sum()) == pytest.approx(300, rel=1e-5)


# -- CLI -----------------------------------------------------------------------------


def test_cli_train_two_state(fasta, tmp_path, monkeypatch, capsys):
    """train --preset two_state --clean writes the model train_file writes
    (at 4 Ki chunks: the CLI trains at the reference's 64 Ki, a slow plain
    chain on the CPU)."""
    real = TPL.train_file
    monkeypatch.setattr(TPL, "train_file", lambda *a, **k: real(*a, chunk_size=CHUNK, **k))
    out = tmp_path / "m.txt"
    rc = cli.main(["train", fasta, "--preset", "two_state", "--clean", "--iters", "3",
                   "--engine", "auto", "--model-out", str(out), "--device", "cpu"])
    assert rc == 0 and "trained" in capsys.readouterr().out
    ref = tmp_path / "ref.txt"
    real(fasta, params=TP.two_state_cpg(), compat=False, num_iters=3, chunk_size=CHUNK,
         model_out=str(ref), device="cpu")
    assert out.read_text() == ref.read_text()
    assert load_text(str(out)).n_states == 2
    # --engine xla trains on the generic engine, as the JAX package's does.
    assert cli.main(["train", fasta, "--preset", "two_state", "--clean", "--engine", "xla",
                     "--iters", "2", "--model-out", str(out), "--device", "cpu"]) == 0
    jr = JPL.train_file(fasta, params=JP.two_state_cpg(), compat=False, num_iters=2,
                        chunk_size=CHUNK, engine="xla")
    got = load_text(str(out))
    for a, b in zip((got.pi, got.A, got.B), (jr.params.pi, jr.params.A, jr.params.B)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# -- routing -------------------------------------------------------------------------


def _routing_model(name):
    if name == "flagship":
        return TP.durbin_cpg8()
    if name == "two_state":
        return TP.two_state_cpg()
    K = {"rand5": 5, "k9": 9}[name]
    return HmmParams.from_probs(np.full(K, 1 / K), np.full((K, K), 1 / K),
                                np.full((K, 4), 0.25))


# (engine, model, the E-step's engine, the posterior's engine)
ROUTES = [
    ("auto", "flagship", "onehot", "onehot"),
    ("auto", "two_state", "pallas", "pallas"),
    ("auto", "rand5", "pallas", "pallas"),
    ("pallas", "flagship", "pallas", "pallas"),
    ("pallas", "two_state", "pallas", "pallas"),
    ("onehot", "two_state", ValueError, ValueError),
    ("pallas", "k9", ValueError, ValueError),
    ("auto", "k9", "xla", "xla"),
    ("xla", "flagship", "xla", "xla"),
    ("xla", "two_state", "xla", "xla"),
]


@pytest.mark.parametrize("router", ["train", "posterior"])
@pytest.mark.parametrize("engine,model,want_train,want_post", ROUTES)
def test_fb_engine_routing(router, engine, model, want_train, want_post):
    """'auto' takes the reduced engine for the flagship's family and the
    dense one for any other model with K <= 8; both routers take the
    generic 'xla' engine for K > 8 and on request, and it runs there: the
    E-step trains, the posterior runs the lane path (finite confidence in
    [0, 1])."""
    params = _routing_model(model)
    want = want_train if router == "train" else want_post
    resolve = ((lambda e, p: TBE.resolve_fb_engine(e, p, "rescaled")) if router == "train"
               else TPO.resolve_fb_engine)
    if isinstance(want, str):
        assert resolve(engine, params) == want
        if want == "xla":
            sym = np.random.default_rng(5).integers(0, 4, size=700).astype(np.uint8)
            if router == "train":
                fit = TBW.fit(params, TCH.frame(sym, 256), num_iters=1, engine=engine)
                assert fit.iterations == 1 and np.isfinite(fit.logliks[0])
            else:
                conf, path = TPO.posterior_sharded(params, sym, (0,), engine=engine,
                                                   want_path=True, block_size=64)
                assert conf.shape == path.shape == sym.shape and np.isfinite(conf).all()
                assert 0.0 <= conf.min() and conf.max() <= 1.0 + 1e-6
        return
    with pytest.raises(want):
        resolve(engine, params)
