"""The port's generic engines (``ops/forward_backward.py``, the "xla"
E-step of ``train/backends.py``) vs the JAX package's, on the CPU, on
seeded numpy inputs.

Bounds, as the JAX package pins them:
- Statistics: rtol 1e-5 on the counts and the loglik (atol 1e-4 for
  counts near zero).  The port's torch matmuls and sums round in another
  order than XLA:CPU's contracted dots.  The log numerics take their
  gammas from exp(alpha + beta - loglik), whose argument cancels terms of
  the size of the chunk's loglik: one float32 ulp of that loglik is the
  relative error of every gamma, so their counts are held to
  max(1e-5, |loglik| * 2^-24) relative, the largest chunk's loglik.
  Between the two numerics, the JAX package's own bound (rtol 1e-3, atol
  1e-2; tests/test_forward_backward.py).
- EM: logliks within rtol 1e-5, probabilities within atol 1e-5, the same
  structural zeros and iteration count (the EM parity bound of the port's
  other training tests); in the log numerics the probabilities within
  max(1e-5, 2 |loglik| * 2^-24) of the largest chunk, the gammas' own
  bound above.
- Island files byte for byte.
Chunks are 4 Ki symbols at most: the generic chains are Python loops over
time, one step vectorized over the chunks.
"""

import io
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import hmm as JH
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import forward_backward as JF
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import cli as TCLI
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import HmmParams, load_text, params_from_numpy
from cpgisland_tpu_torch.ops import forward_backward as TF
from cpgisland_tpu_torch.ops import loglik as TL
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

CHUNK = 4096
PAD = 4


def _tp(jp):
    return params_from_numpy(np.asarray(jp.log_pi), np.asarray(jp.log_A), np.asarray(jp.log_B))


def _model(name):
    """(JAX params, port params): the flagship, two_state, or a seeded dense
    random model of K states over 4 symbols (outside both kernel domains
    at K > 8)."""
    if name == "flagship":
        jp = JP.durbin_cpg8()
    elif name == "two_state":
        jp = JP.two_state_cpg()
    else:
        jp = JP.random_hmm(jax.random.PRNGKey(int(name[1:])), int(name[1:]), 4)
    return jp, _tp(jp)


def _ragged(rng, N=6, T=1500, S=4):
    obs = rng.integers(0, S, size=(N, T)).astype(np.uint8)
    lens = np.array([T, T // 2, 1, 0, T - 1, 3][:N], np.int32)
    for i, n in enumerate(lens):
        obs[i, n:] = PAD
    return obs, lens


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The generic chains run a few small ops a step: under a parallel test
    run every op forking PyTorch's thread pool costs tens of times more
    (as in tests/test_torch_dense_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log_rtol(params, obs, lens):
    """max(1e-5, one float32 ulp of the largest chunk loglik, relative)."""
    obs_c, valid = TF._masks(params, torch.as_tensor(np.asarray(obs)),
                             torch.as_tensor(np.asarray(lens)))
    _, cs = TF._rescaled_forward(params, obs_c, valid)
    per = torch.sum(torch.where(valid, torch.log(cs), 0.0), 1)
    return max(1e-5, float(torch.max(torch.abs(per))) * 2.0 ** -24)


def _stats_close(t, j, rtol=1e-5, atol=1e-4):
    for f in ("init", "trans", "emit", "loglik"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert int(t.n_seqs) == int(j.n_seqs)


# -- forward-backward statistics --------------------------------------------------


@pytest.mark.parametrize("mode", ["rescaled", "log"])
@pytest.mark.parametrize("name", ["flagship", "two_state", "k3", "k10"])
def test_batch_stats_equal_jax_at_ragged_lengths(rng, mode, name):
    jp, tp = _model(name)
    obs, lens = _ragged(rng)
    want = JF.batch_stats(jp, jnp.asarray(obs), jnp.asarray(lens), mode=mode)
    got = TF.batch_stats(tp, torch.from_numpy(obs), torch.from_numpy(lens), mode=mode)
    _stats_close(got, want, rtol=_log_rtol(tp, obs, lens) if mode == "log" else 1e-5)
    assert int(got.n_seqs) == 5  # the empty chunk adds nothing


@pytest.mark.parametrize("mode", ["rescaled", "log"])
@pytest.mark.parametrize("length", [700, 350, 1, 0])
def test_chunk_stats_equal_jax(rng, mode, length):
    jp, tp = _model("k9")
    obs = rng.integers(0, 4, size=700).astype(np.uint8)
    obs[length:] = PAD
    want = JF.chunk_stats(jp, jnp.asarray(obs), jnp.int32(length), mode=mode)
    got = TF.chunk_stats(tp, obs, length, mode=mode)
    _stats_close(got, want, rtol=_log_rtol(tp, [obs], [length]) if mode == "log" else 1e-5)


def test_log_and_rescaled_numerics_agree(rng):
    """The two numerics of the port within the JAX package's own bound
    between its two (tests/test_forward_backward.py)."""
    _, tp = _model("k10")
    obs, lens = _ragged(rng, T=800)
    a = TF.batch_stats(tp, obs, lens, mode="log")
    b = TF.batch_stats(tp, obs, lens, mode="rescaled")
    for f in ("trans", "emit"):
        np.testing.assert_allclose(getattr(a, f).numpy(), getattr(b, f).numpy(),
                                   rtol=1e-3, atol=1e-2)
    with pytest.raises(ValueError, match="numerics"):
        TF.batch_stats(tp, obs, lens, mode="linear")


@pytest.mark.parametrize("case", ["plain", "pad_first", "pad_inside", "short_length",
                                  "impossible"])
def test_generic_sequence_loglik_equals_jax(rng, case):
    """A K = 10 model scores through the serial chain (scoring engine
    "xla"), PAD positional, an impossible observation -inf."""
    jp, tp = _model("k10")
    obs = rng.integers(0, 4, size=3000).astype(np.uint8)
    length = None
    if case == "pad_first":
        obs[:5] = PAD
    elif case == "pad_inside":
        obs[100:140] = PAD
    elif case == "short_length":
        length = 1234
    elif case == "impossible":  # symbol 3 has zero emission in every state
        B = np.exp(np.asarray(jp.log_B, np.float64))
        B[:, 3] = 0.0
        jp = JH.HmmParams.from_probs(np.exp(np.asarray(jp.log_pi, np.float64)),
                           np.exp(np.asarray(jp.log_A, np.float64)), B / B.sum(1, keepdims=True))
        tp = _tp(jp)
        obs = np.where(obs == 3, 0, obs).astype(np.uint8)
        obs[2345] = 3
    assert TL.scoring_engine(tp) == "xla"
    want = float(JF.sequence_loglik(jp, jnp.asarray(obs), length))
    got = TL.sequence_loglik(tp, obs, length)
    assert isinstance(got, float)
    if case == "impossible":
        assert got == want == -math.inf
        return
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(TF.sequence_loglik(tp, obs, length), want, rtol=1e-5)


@pytest.mark.parametrize("form", ["memmap", "tensor"])
def test_generic_sequence_loglik_takes_a_cache_slice_or_a_tensor(rng, tmp_path, form):
    """The serial chain's input goes through ``chunking.upload``: a symbol
    cache's read-only memmap slice is copied (no warning, with warnings
    turned into errors), a tensor moves as it is; the score is the numpy
    array's."""
    _, tp = _model("k10")
    obs = rng.integers(0, 4, size=2500).astype(np.uint8)
    want = TL.sequence_loglik(tp, obs, 2000)
    if form == "memmap":
        path = tmp_path / "s.npy"
        np.save(path, obs)
        src = np.load(path, mmap_mode="r")[100:]
        want = TL.sequence_loglik(tp, obs[100:], 2000)
    else:
        src = torch.from_numpy(obs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = TL.sequence_loglik(tp, src, 2000)
    assert got == want


# -- the xla E-step and its routing ---------------------------------------------


ROUTES = [
    ("auto", "flagship", "rescaled", "onehot"),
    ("auto", "two_state", "rescaled", "pallas"),
    ("auto", "k9", "rescaled", "xla"),
    ("auto", "flagship", "log", "xla"),
    ("auto", "two_state", "log", "xla"),
    ("xla", "flagship", "log", "xla"),
    ("xla", "k10", "rescaled", "xla"),
    ("pallas", "two_state", "log", ValueError),
    ("onehot", "flagship", "log", ValueError),
    ("auto", "flagship", "linear", ValueError),
]


@pytest.mark.parametrize("engine,name,mode,want", ROUTES)
def test_auto_resolves_as_the_jax_router_on_its_tpu(engine, name, mode, want):
    _, tp = _model(name)
    if isinstance(want, str):
        assert TBE.resolve_fb_engine(engine, tp, mode) == want
    else:
        with pytest.raises(want):
            TBE.resolve_fb_engine(engine, tp, mode)


def _fit_pair(name, mode, rng, iters=3, engine="xla", fuse="auto"):
    jp, tp = _model(name)
    n = 3 * CHUNK + 1234
    sym = rng.integers(0, 4, size=n).astype(np.uint8)
    jc = JCH.frame(sym, CHUNK)
    tc = TCH.frame(sym, CHUNK)
    jr = JBW.fit(jp, jc, num_iters=iters, convergence=0.0,
                 backend=JBE.LocalBackend(mode=mode, engine="xla"))
    tr = TBW.fit(tp, tc, num_iters=iters, convergence=0.0,
                 backend=TBE.LocalBackend(mode=mode, engine=engine), fuse=fuse)
    tr.log_atol = max(1e-5, 2 * _log_rtol(tp, tc.chunks, tc.lengths))
    return jr, tr


def _same_model(jparams, tparams, atol=1e-5):
    for j, t in zip((jparams.pi, jparams.A, jparams.B), (tparams.pi, tparams.A, tparams.B)):
        j, t = np.asarray(j, np.float64), t.numpy().astype(np.float64)
        np.testing.assert_allclose(t, j, atol=atol)
        assert np.array_equal(t == 0, j == 0)


def _fits_agree(jr, tr, atol=1e-5):
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    _same_model(jr.params, tr.params, atol)


@pytest.mark.parametrize("name,mode", [("k9", "rescaled"), ("k10", "rescaled"),
                                       ("k10", "log"), ("flagship", "rescaled"),
                                       ("flagship", "log")])
def test_local_xla_fit_equals_jax(rng, name, mode):
    jr, tr = _fit_pair(name, mode, rng)
    _fits_agree(jr, tr, tr.log_atol if mode == "log" else 1e-5)
    assert all(b >= a - 1e-5 * abs(a) for a, b in zip(tr.logliks, tr.logliks[1:]))


def test_auto_takes_xla_for_a_wide_model_and_the_loops_agree(rng):
    """engine="auto" trains a K = 10 model on the generic engine; the device
    loop and the host loop give the same fit bit for bit."""
    jr, tr = _fit_pair("k10", "rescaled", rng, engine="auto")
    _fits_agree(jr, tr)
    _, th = _fit_pair("k10", "rescaled", np.random.default_rng(0), engine="auto", fuse="off")
    _, td = _fit_pair("k10", "rescaled", np.random.default_rng(0), engine="auto", fuse="on")
    assert th.logliks == td.logliks
    for a, b in zip((th.params.log_pi, th.params.log_A, th.params.log_B),
                    (td.params.log_pi, td.params.log_A, td.params.log_B)):
        assert torch.equal(a, b)


def test_seq2d_rows_route_takes_xla(rng):
    """Seq2DBackend's rows-chunked route (records up to 64 Ki, one a lane)
    resolves like LocalBackend: a K = 10 model runs the generic engine,
    equal to its batch_stats over the same rows."""
    _, tp = _model("k10")
    recs = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (900, 2500, 40)]
    backend = TBE.Seq2DBackend(block_size=256)
    placed = backend.place(backend.prepare(TCH.bucket_records(iter(recs), floor=1024)), "cpu")
    got = backend(tp, *placed)
    groups = [TF.batch_stats(tp, rows, lens, mode="rescaled") for rows, lens in zip(*placed)]
    assert len(groups) == 2
    _stats_close(got, groups[0] + groups[1], rtol=0, atol=0)


# -- run with any model ---------------------------------------------------------


def _seq(rng, n):
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    s[cg[rng.random(cg.size) < 0.75] + 1] = 0
    for a in range(300, n - 900, 3000):
        s[a : a + 700] = rng.choice(4, size=700, p=[0.15, 0.35, 0.35, 0.15])
    return s


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(23)
    path = tmp_path / "run.fa"
    with open(path, "w") as f:
        for i, n in enumerate((6000, 9000, 3000)):
            txt = "".join("ACGT"[x] for x in _seq(rng, n))
            f.write(f">r{i} x\n" + "\n".join(txt[j : j + 60] for j in range(0, n, 60)) + "\n")
    return str(path)


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages' train_file at 4 Ki chunks (run trains at the
    reference's 64 Ki, a slow plain chain on the CPU)."""
    for mod in (JPL, TPL):
        real = mod.train_file
        monkeypatch.setattr(mod, "train_file",
                            lambda *a, _r=real, **k: _r(*a, chunk_size=CHUNK, **k))


@pytest.mark.parametrize("mode", ["rescaled", "log"])
def test_run_two_state_writes_the_jax_islands(fasta, tmp_path, small_chunks, mode):
    """run(params=two_state, island_states=(0,), compat=False): off its TPU
    the JAX package trains on its xla engine, the port on the dense
    kernels' plain versions (rescaled) or the generic engine (log)."""
    ji, jm, ti, tm = (str(tmp_path / x) for x in ("ji", "jm", "ti", "tm"))
    JPL.run(fasta, fasta, ji, jm, 0.0, 3, params=JP.two_state_cpg(), island_states=(0,),
            compat=False, mode=mode)
    res = TPL.run(fasta, fasta, ti, tm, 0.0, 3, params=TP.two_state_cpg(), island_states=(0,),
                  compat=False, mode=mode, device="cpu")
    assert open(ti).read() == open(ji).read() and len(res.calls) > 0
    _same_model(JH.load_text(jm), load_text(tm))


def test_cli_run_preset_two_state_log_numerics(fasta, tmp_path, small_chunks, capsys):
    isl, mod = str(tmp_path / "i.txt"), str(tmp_path / "m.txt")
    assert TCLI.main(["run", fasta, fasta, "--islands-out", isl, "--model-out", mod,
                      "--preset", "two_state", "--island-states", "0", "--clean",
                      "--numerics", "log", "--iters", "2", "--device", "cpu"]) == 0
    assert "islands ->" in capsys.readouterr().out
    ji = str(tmp_path / "ji.txt")
    JPL.run(fasta, fasta, ji, str(tmp_path / "jm.txt"), 0.005, 2, params=JP.two_state_cpg(),
            island_states=(0,), compat=False, mode="log")
    assert open(isl).read() == open(ji).read()


def test_cli_run_parse_time_checks(fasta, tmp_path):
    out = ["--islands-out", str(tmp_path / "i"), "--model-out", str(tmp_path / "m")]
    for argv in (["--preset", "two_state", "--clean"],  # no island states for K != 2M
                 ["--island-states", "0"],  # needs --clean
                 ["--symbol-cache", str(tmp_path / "c")],  # needs --clean
                 ["--island-states", "x,y", "--clean"]):
        with pytest.raises(SystemExit):
            TCLI.main(["run", fasta, fasta, *out, *argv, "--device", "cpu"])
    for kw in ({"checkpoint_dir": str(tmp_path)}, {"prefetch": 2}):
        with pytest.raises(NotImplementedError, match="A12"):
            TPL.run(fasta, fasta, *out[1::2], compat=False, device="cpu", **kw)


def test_run_params_default_to_durbin(fasta, tmp_path, small_chunks):
    a = [str(tmp_path / x) for x in ("a.i", "a.m")]
    b = [str(tmp_path / x) for x in ("b.i", "b.m")]
    TPL.run(fasta, fasta, *a, 0.0, 1, compat=False, device="cpu")
    TPL.run(fasta, fasta, *b, 0.0, 1, params=TP.durbin_cpg8(), compat=False, device="cpu")
    assert [open(p).read() for p in a] == [open(p).read() for p in b]


def test_train_file_wide_model_and_cli_numerics(fasta, tmp_path, monkeypatch, capsys):
    """train_file trains a K = 10 model (auto -> xla) as JAX's xla engine
    does; the CLI's --numerics log reaches the E-step."""
    jp, tp = _model("k10")
    jr = JPL.train_file(fasta, params=jp, num_iters=2, convergence=0.0, compat=False,
                        chunk_size=CHUNK)
    tr = TPL.train_file(fasta, params=tp, num_iters=2, convergence=0.0, compat=False,
                        chunk_size=CHUNK, device="cpu")
    _fits_agree(jr, tr)
    seen = []
    real = TF.batch_stats
    monkeypatch.setattr(TF, "batch_stats", lambda *a, **k: seen.append(k.get("mode")) or
                        real(*a, **k))
    real_train = TPL.train_file
    monkeypatch.setattr(TPL, "train_file", lambda *a, **k: real_train(*a, chunk_size=CHUNK, **k))
    assert TCLI.main(["train", fasta, "--model-out", str(tmp_path / "m.txt"), "--clean",
                      "--iters", "1", "--numerics", "log", "--device", "cpu"]) == 0
    assert seen == ["log"]
    assert isinstance(tp, HmmParams)
