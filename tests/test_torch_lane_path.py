"""The generic lane path (``parallel.fb_sharded``: whole-sequence statistics,
posterior and span totals at any K) in the PyTorch port vs the JAX package's
XLA lane path, on the CPU, on EQUAL meshes: a port mesh of D entries that all
name the CPU against the conftest's first D virtual CPU devices.

Statistics are held within rtol 1e-5 / atol 1e-4 (the sums run in other
orders), confidence within atol 2e-5 (the JAX package's own posterior parity
bound between its engines), MPM paths and island files exactly.  Lanes are
``block_size`` 64 steps, as ``tests/test_fb_sharded.py`` uses.
"""

import io

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.parallel import fb_sharded as JFS
from cpgisland_tpu.parallel import posterior as JPO
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import family as TF
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import HmmParams as THmm
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.parallel import fb_sharded as TFS
from cpgisland_tpu_torch.parallel import posterior as TPO
from cpgisland_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

BLOCK = 64
STATS_TOL = dict(rtol=1e-5, atol=1e-4)
CONF_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """The lane path is a Python loop over a lane's steps: one torch thread
    keeps xdist workers from forking thread pools a step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k10():
    """A K = 10 model outside both kernel domains: states 0-3 GC-rich and
    sticky among themselves (the island states), 4-9 the background, every
    emission row dense and perturbed at random."""
    rng = np.random.default_rng(10)
    nrm = lambda x: x / x.sum(-1, keepdims=True)
    isl = np.arange(10) < 4
    A = np.where(isl[:, None] == isl[None, :], 1.0, 0.004) * (1.0 + rng.random((10, 10)))
    A = nrm(A + np.eye(10) * 30.0)
    base = np.where(isl[:, None], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.2, 0.3])
    B = nrm(base * (1.0 + 0.3 * rng.random((10, 4))))
    return nrm(1.0 + rng.random(10)), A, B


def _model(name):
    """(JAX params, port params) of the same model."""
    if name == "k10":
        pi, A, B = _k10()
        jp = JHmm.from_probs(pi, A, B)
    else:
        jp = getattr(JP, name)()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _jmesh(D, axis="seq"):
    return Mesh(np.array(jax.devices()[:D]), (axis,))


def _tmesh(D, axis="seq"):
    return make_mesh(D, axis=axis, device="cpu")


def _stream(rng, n, gc=0.45):
    return rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]).astype(np.uint8)


def _stats_close(t, j):
    for f in ("init", "trans", "emit", "loglik"):
        np.testing.assert_allclose(np.asarray(getattr(t, f)), np.asarray(getattr(j, f)),
                                   **STATS_TOL)
    assert int(t.n_seqs) == int(j.n_seqs)


# -- seq_stats_sharded -----------------------------------------------------------


@pytest.mark.parametrize("model", ["durbin_cpg8", "two_state_cpg", "k10"])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_seq_stats_sharded_matches_jax(rng, model, D):
    """One sequence over D shards; 1,100 symbols at D = 8 leave the last
    shards mostly or wholly padding (shards of 192 symbols)."""
    jp, tp = _model(model)
    obs = _stream(rng, 1100 if D == 8 else 2000)
    j = JFS.seq_stats_sharded(jp, obs, mesh=_jmesh(D), block_size=BLOCK)
    t = TFS.seq_stats_sharded(tp, obs, mesh=_tmesh(D), block_size=BLOCK)
    _stats_close(t, j)


def test_seq_stats_sharded_equals_chunk_free_sum(rng):
    """The exchange is exact: 1 and 4 shards of one sequence agree."""
    _, tp = _model("k10")
    obs = _stream(rng, 1500)
    one = TFS.seq_stats_sharded(tp, obs, mesh=_tmesh(1), block_size=BLOCK)
    four = TFS.seq_stats_sharded(tp, obs, mesh=_tmesh(4), block_size=BLOCK)
    _stats_close(four, one)


@pytest.mark.parametrize("dp,sp", [(2, 4), (8, 1)])
def test_batch_seq_stats_sharded_matches_jax(rng, dp, sp):
    jp, tp = _model("k10")
    seqs = [_stream(rng, n) for n in (700, 64, 1300)]
    jmesh = Mesh(np.array(jax.devices()[: dp * sp]).reshape(dp, sp), ("data", "seq"))
    j = JFS.batch_seq_stats_sharded(jp, seqs, mesh=jmesh, block_size=BLOCK)
    t = TFS.batch_seq_stats_sharded(tp, seqs, mesh=make_mesh2d(dp, sp, device="cpu",
                                                               n_devices=dp * sp),
                                    block_size=BLOCK)
    _stats_close(t, j)


@pytest.mark.parametrize("dp,sp", [(2, 4), (8, 1)])
def test_sharded_stats2d_fn_kernel_engine_matches_jax(rng, dp, sp):
    """The 2-D entry point on the dense kernels' plain versions (two_state)
    against the JAX package's XLA lane path over the same batch."""
    jp, tp = _model("two_state_cpg")
    seqs = [_stream(rng, n) for n in (900, 300, 1300)]
    rows, lens = TFS.pack_ragged(seqs, 2)
    obs, lengths = TFS.pad_batch2d(rows, lens, dp, sp, BLOCK, 2)
    jmesh = Mesh(np.array(jax.devices()[: dp * sp]).reshape(dp, sp), ("data", "seq"))
    j = JFS.batch_seq_stats_sharded(jp, seqs, mesh=jmesh, block_size=BLOCK)
    tmesh = make_mesh2d(dp, sp, device="cpu", n_devices=dp * sp)
    tiles, lens2d = TFS.place_batch2d(tmesh, obs, lengths)
    t = TFS.sharded_stats2d_fn(tmesh, BLOCK, "pallas", 64)(tp, tiles, lens2d)
    _stats_close(t, j)


# -- the posterior pass -------------------------------------------------------------


def _place(mesh_t, obs, S):
    obs_p, lengths = TFS.shard_sequence(obs, mesh_t.size, BLOCK, S)
    return TFS.place_shards(mesh_t, obs_p), [int(n) for n in lengths]


@pytest.mark.parametrize("want_path", [False, True])
@pytest.mark.parametrize("span", ["first", "continuation"])
def test_one_seq_local_posterior_matches_jax(rng, want_path, span):
    """A first span and a continuation span entered and left with threaded
    directions, over 4 shards: confidence within atol 2e-5, paths equal."""
    jp, tp = _model("k10")
    obs = _stream(rng, 1500)
    mask = np.zeros(10, np.float32)
    mask[:4] = 1.0
    kw = {}
    if span == "continuation":
        r = np.random.default_rng(3)
        enter, exit_ = r.random(10).astype(np.float32), r.random(10).astype(np.float32)
        kw = dict(first=False, enter_dir=enter / enter.sum(), exit_dir=exit_ / exit_.sum())
    jconf, jpath = JPO.posterior_sharded(
        jp, obs, tuple(range(4)), mesh=_jmesh(4), block_size=BLOCK, engine="xla",
        want_path=want_path, **kw)
    shards, lens = _place(_tmesh(4), obs, 4)
    out = TFS.lane_posterior(tp, shards, lens, mask, block_size=BLOCK, want_path=want_path, **kw)
    conf = np.concatenate([c.numpy() for c, _ in out])[: obs.size]
    np.testing.assert_allclose(conf, np.asarray(jconf), atol=CONF_ATOL)
    if want_path:
        path = np.concatenate([p.numpy() for _, p in out])[: obs.size]
        assert np.array_equal(path, np.asarray(jpath))


@pytest.mark.parametrize("D", [1, 4])
def test_posterior_sharded_xla_matches_jax(rng, D):
    jp, tp = _model("k10")
    obs = _stream(rng, 1900)
    jconf, jpath = JPO.posterior_sharded(jp, obs, (0, 1, 2), mesh=_jmesh(D), block_size=BLOCK,
                                         engine="xla", want_path=True)
    conf, path = TPO.posterior_sharded(tp, obs, (0, 1, 2), mesh=_tmesh(D), block_size=BLOCK,
                                       engine="xla", want_path=True)
    np.testing.assert_allclose(conf, np.asarray(jconf), atol=CONF_ATOL)
    assert np.array_equal(path, np.asarray(jpath))


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("D", [1, 4])
def test_transfer_total_sharded_xla_matches_jax(rng, first, D):
    jp, tp = _model("k10")
    obs = _stream(rng, 1700)
    j = JPO.transfer_total_sharded(jp, obs, mesh=_jmesh(D), block_size=BLOCK, engine="xla",
                                   first=first, prev_sym=int(obs[0]))
    t = TPO.transfer_total_sharded(tp, obs, mesh=_tmesh(D), block_size=BLOCK, engine="xla",
                                   first=first, prev_sym=int(obs[0]))
    np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-7)


# -- the pipelines ------------------------------------------------------------------


def _fasta(path, rng, sizes):
    with open(path, "w") as f:
        for i, n in enumerate(sizes):
            s = _stream(rng, n)
            a = n // 3
            s[a : a + n // 4] = rng.choice([1, 2], size=n // 4)
            f.write(f">r{i}\n" + "".join("ACGT"[x] for x in s) + "\n")
    return str(path)


def _k10_jt():
    pi, A, B = _k10()
    # Islands from the observations: states 0-3 count as island.
    return JHmm.from_probs(pi, A, B), THmm.from_probs(pi, A, B)


@pytest.mark.parametrize("span", [None, 1500])
def test_posterior_file_k10_matches_jax(tmp_path, rng, span):
    """A K = 10 model's posterior_file: island file byte for byte and the
    confidence within atol 2e-5, one span and span-threaded."""
    fa = _fasta(tmp_path / "g.fa", rng, [3000, 800])
    jp, tp = _k10_jt()
    kw = {} if span is None else {"span": span}
    jconf, tconf = tmp_path / "j.npy", tmp_path / "t.npy"
    jisl, tisl = io.StringIO(), io.StringIO()
    JPL.posterior_file(fa, jp, islands_out=jisl, confidence_out=str(jconf),
                       island_states=(0, 1, 2, 3), engine="xla", **kw)
    TPL.posterior_file(fa, tp, islands_out=tisl, confidence_out=str(tconf),
                       island_states=(0, 1, 2, 3), device="cpu", **kw)
    assert tisl.getvalue() == jisl.getvalue() and tisl.getvalue().count("\n") >= 2
    np.testing.assert_allclose(np.load(tconf), np.load(jconf), atol=CONF_ATOL)


def test_compare_file_k10_member_matches_jax(tmp_path, rng):
    from cpgisland_tpu import family as JF

    fa = _fasta(tmp_path / "g.fa", rng, [2500, 900])
    jp, tp = _k10_jt()
    jmembers = [JF.Member("k10", jp, (0, 1, 2, 3), 1), JF.builtin_member("null")]
    tmembers = [TF.Member("k10", tp, (0, 1, 2, 3), 1), TF.builtin_member("null")]
    jout, tout = io.StringIO(), io.StringIO()
    jres = JPL.compare_file(fa, jmembers, out=jout, engine="xla")
    tres = TPL.compare_file(fa, tmembers, out=tout, device="cpu")
    # Record and winner-track lines byte for byte; the model lines' logliks
    # within rtol 1e-5 (the scoring sums run in other orders), as
    # tests/test_torch_compare.py holds them.
    g, w = tout.getvalue().splitlines(), jout.getvalue().splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if not a.startswith("# model "):
            assert a == b
            continue
        a, b = a.split(), b.split()
        assert a[:4] + a[7:] == b[:4] + b[7:]
        np.testing.assert_allclose(float(a[4]), float(b[4]), rtol=1e-5)
    assert sum(len(m.calls) for rc in tres.records for m in rc.members) > 0
    for tr, jr in zip(tres.records, jres.records):
        np.testing.assert_array_equal(tr.winner, np.asarray(jr.winner))
        for tm, jm in zip(tr.members, jr.members):
            assert tm.calls.format_lines() == jm.calls.format_lines()
            np.testing.assert_allclose(tm.conf, np.asarray(jm.conf), atol=CONF_ATOL)


# -- whole-sequence fits on the lane path ----------------------------------------------


ITERS = 2


def _fits_agree(jr, tr):
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    for j, t in zip((jr.params.pi, jr.params.A, jr.params.B),
                    (tr.params.pi, tr.params.A, tr.params.B)):
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   atol=1e-5)


@pytest.mark.parametrize("model", ["durbin_cpg8", "k10"])
def test_seq_backend_xla_fit_matches_jax(rng, model):
    jp, tp = _model(model)
    ch = TCH.frame(_stream(rng, 2500), 1024)
    jch = JCH.Chunked(chunks=ch.chunks, lengths=ch.lengths, total=ch.total)
    eng = "xla" if model == "durbin_cpg8" else "auto"
    jr = JBW.fit(jp, jch, num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_jmesh(1), block_size=BLOCK, engine="xla"))
    backend = TBE.SeqBackend(block_size=BLOCK, engine=eng)
    tr = TBW.fit(tp, ch, num_iters=ITERS, convergence=0.0, backend=backend)
    assert backend.resolved == "xla"
    _fits_agree(jr, tr)


def test_seq2d_backend_xla_fit_matches_jax(rng):
    """Records above 64 Ki symbols take the whole-sequence route; with
    ``engine="xla"`` the lane path, one record after another."""
    jp, tp = _model("k10")
    recs = [_stream(rng, n) for n in (70_000, 1_000)]
    b = TCH.bucket_records(iter(recs), pad_value=4)
    jb = JCH.bucket_records(iter(recs), pad_value=4)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    jr = JBW.fit(jp, jb, num_iters=1, convergence=0.0,
                 backend=JBE.Seq2DBackend(mesh=jmesh, block_size=2048, engine="xla"))
    backend = TBE.Seq2DBackend(block_size=2048, engine="xla")
    tr = TBW.fit(tp, b, num_iters=1, convergence=0.0, backend=backend)
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    for j, t in zip((jr.params.A, jr.params.B), (tr.params.A, tr.params.B)):
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   atol=1e-5)
