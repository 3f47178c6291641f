"""The port's device mesh on one host (``parallel.mesh``) and the paths over
it — ``SpmdBackend``, ``SeqBackend`` / ``Seq2DBackend`` with a mesh, the
sharded decode and posterior, the dryrun tool — vs the JAX package on the
CPU, on EQUAL meshes: a port mesh of D entries that all name the CPU against
the conftest's first D virtual CPU devices.

Statistics and fits are held within the EM parity bound (logliks rtol 1e-5,
probabilities atol 1e-5), decode paths exactly, confidence within atol 2e-5.
A one-entry mesh runs the one-device code: bit for bit today's result.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.parallel import decode as JD
from cpgisland_tpu.parallel import posterior as JPO
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.parallel import decode as TD
from cpgisland_tpu_torch.parallel import mesh as TM
from cpgisland_tpu_torch.parallel import posterior as TPO
from cpgisland_tpu_torch.tools import dryrun_mesh
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

ITERS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain chains are Python loops of small tensor ops: one torch
    thread keeps xdist workers from forking thread pools a step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name="durbin_cpg8"):
    jp = getattr(JP, name)()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _jmesh(D, axis="seq"):
    return JMesh(np.array(jax.devices()[:D]), (axis,))


def _tmesh(D, axis="seq"):
    return TM.make_mesh(D, axis=axis, device="cpu")


def _stream(rng, n, gc=0.45):
    s = rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]).astype(np.uint8)
    a = n // 3
    s[a : a + n // 5] = rng.choice([1, 2], size=n // 5)  # a GC-rich stretch
    return s


def _jchunked(ch):
    return JCH.Chunked(chunks=ch.chunks, lengths=ch.lengths, total=ch.total)


def _fits_agree(jr, tr):
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    for j, t in zip((jr.params.pi, jr.params.A, jr.params.B),
                    (tr.params.pi, tr.params.A, tr.params.B)):
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   atol=1e-5)


# -- the mesh ----------------------------------------------------------------------


def test_mesh_shapes():
    m = TM.make_mesh(8, axis="seq", device="cpu")
    assert (m.axis_names, dict(m.shape), m.size) == (("seq",), {"seq": 8}, 8)
    assert m.first == torch.device("cpu") and len(m.device_list) == 8
    assert TM.make_mesh(device="cpu").size == 1  # one entry names the CPU
    m2 = TM.make_mesh2d(2, device="cpu", n_devices=8)
    assert dict(m2.shape) == {"data": 2, "seq": 4}
    assert TM.auto_mesh2d(3, device="cpu", n_devices=8).devices.shape == (2, 4)
    assert TM.auto_mesh2d(1, device="cpu", n_devices=8).devices.shape == (1, 8)
    assert TM.auto_mesh2d(12, device="cpu", n_devices=8).devices.shape == (8, 1)
    assert TM.local_device_count("cpu") == 1
    with pytest.raises(ValueError, match="divisible"):
        TM.make_mesh2d(3, device="cpu", n_devices=8)
    with pytest.raises(ValueError, match="requested"):
        TM.make_mesh2d(4, 4, device="cpu", n_devices=8)
    # More cards than there are (none on this host), or more than one for a
    # named card, raise.
    with pytest.raises(ValueError, match="requested"):
        TM.make_mesh(torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ValueError, match="names one card"):
        TM.make_mesh(2, device="cuda:0")
    assert TM.Mesh(["cuda:1"] * 2, ("seq",)).first == torch.device("cuda", 1)
    assert TM.Mesh(["cpu"] * 3, ("seq",)) == _tmesh(3)


def test_a_jax_mesh_is_refused():
    jm = _jmesh(1)
    for make in (lambda: TBE.get_backend("seq", mesh=jm), lambda: TBE.SeqBackend(mesh=jm),
                 lambda: TBE.SpmdBackend(mesh=jm),
                 lambda: TBE.Seq2DBackend(mesh=JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                                     ("data", "seq")))):
        with pytest.raises(TypeError, match="cpgisland_tpu_torch"):
            make()
    _, tp = _both()
    with pytest.raises(TypeError):
        TD.viterbi_sharded(tp, np.zeros(10, np.uint8), mesh=jm)
    with pytest.raises(TypeError):
        TPO.posterior_sharded(tp, np.zeros(10, np.uint8), (0,), mesh=jm)


def test_fetch_sharded_prefix():
    parts = [torch.arange(4), torch.arange(4, 8)]
    assert np.array_equal(TM.fetch_sharded_prefix(parts, 6, False), np.arange(6))
    assert torch.equal(TM.fetch_sharded_prefix(parts, 5, True), torch.arange(5))


# -- SpmdBackend ------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_spmd_backend_matches_jax(rng, engine):
    """Chunks over an 8-entry data axis (11 chunks: padded to 16 with empty
    ones) against the JAX SpmdBackend on 8 devices."""
    jp, tp = _both()
    ch = TCH.frame(_stream(rng, 11 * 512 - 100), 512)
    jr = JBW.fit(jp, _jchunked(ch), num_iters=ITERS, convergence=0.0,
                 backend=JBE.SpmdBackend(mesh=_jmesh(8, "data"), engine="xla"))
    backend = TBE.SpmdBackend(mesh=_tmesh(8, "data"), engine=engine)
    tr = TBW.fit(tp, ch, num_iters=ITERS, convergence=0.0, backend=backend)
    _fits_agree(jr, tr)
    # One entry: the local backend bit for bit.
    one = TBW.fit(tp, ch, num_iters=ITERS, convergence=0.0,
                  backend=TBE.SpmdBackend(mesh=_tmesh(1, "data"), engine=engine))
    loc = TBW.fit(tp, ch, num_iters=ITERS, convergence=0.0, backend=TBE.LocalBackend(
        engine=engine))
    assert one.logliks == loc.logliks


# -- SeqBackend over a mesh ------------------------------------------------------------


@pytest.mark.parametrize("engine,preset", [("onehot", "durbin_cpg8"),
                                           ("pallas", "two_state_cpg")])
def test_seq_backend_mesh_matches_jax(rng, engine, preset):
    """One sequence over 8 shards on the kernels (their plain versions here)
    against the JAX SeqBackend on 8 devices, same engine."""
    jp, tp = _both(preset)
    ch = TCH.frame(_stream(rng, 8 * 600), 1024)
    kw = dict(engine=engine, lane_T=256, block_size=128)
    jr = JBW.fit(jp, _jchunked(ch), num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_jmesh(8), t_tile=128, **kw))
    backend = TBE.SeqBackend(mesh=_tmesh(8), **kw)
    tr = TBW.fit(tp, ch, num_iters=ITERS, convergence=0.0, backend=backend)
    assert backend.resolved == engine
    _fits_agree(jr, tr)


@pytest.mark.parametrize("engine", ["onehot", "xla"])
def test_one_entry_mesh_is_the_one_device_result(rng, engine):
    _, tp = _both()
    stream = _stream(rng, 3000)
    ch = TCH.frame(stream, 1024)
    a = TBE.SeqBackend(mesh=_tmesh(1), engine=engine, lane_T=512, block_size=256)
    b = TBE.SeqBackend(engine=engine, lane_T=512, block_size=256)
    sa = a(tp, *a.place(a.prepare(ch), "cpu"))
    sb = b(tp, *b.place(b.prepare(ch), "cpu"))
    for f in ("init", "trans", "emit", "loglik", "n_seqs"):
        assert torch.equal(getattr(sa, f), getattr(sb, f))
    if engine == "onehot":
        obs = torch.from_numpy(np.concatenate([stream, np.full(72, 4, np.uint8)]))
        direct = fb_seq.seq_stats(tp, obs, stream.size, lane_T=512, engine="onehot")
        assert torch.equal(sa.trans, direct.trans) and torch.equal(sa.loglik, direct.loglik)


def test_seq2d_backend_mesh_matches_jax(rng):
    """Three records on a 2 x 4 mesh (rows over data, time over seq)."""
    jp, tp = _both()
    recs = [_stream(rng, n) for n in (1500, 700, 2100)]
    rows, lens = TCH.bucket_records(iter(recs), floor=4096), None
    jb = JCH.bucket_records(iter(recs), floor=4096)
    jm = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "seq"))
    jr = JBW.fit(jp, jb, num_iters=ITERS, convergence=0.0,
                 backend=JBE.Seq2DBackend(mesh=jm, block_size=128, engine="xla"))
    for eng in ("xla", "onehot"):
        backend = TBE.Seq2DBackend(mesh=TM.make_mesh2d(2, 4, device="cpu", n_devices=8),
                                   block_size=128, engine=eng, lane_T=256)
        tr = TBW.fit(tp, rows, num_iters=ITERS, convergence=0.0, backend=backend)
        _fits_agree(jr, tr)
    del lens


def test_second_iteration_builds_no_prep(rng):
    """The mesh's preps are one cache entry per placed input: a second
    E-step (and a second EM iteration) builds nothing, even with more
    shards than the cache has entries."""
    _, tp = _both()
    ch = TCH.frame(_stream(rng, 12 * 300), 1024)
    for backend in (TBE.SeqBackend(mesh=_tmesh(12), engine="onehot", lane_T=256,
                                   block_size=128),
                    TBE.SpmdBackend(mesh=_tmesh(12, "data"))):
        chunks, lengths = backend.place(backend.prepare(ch), "cpu")
        TPR.clear_cache()
        first = backend(tp, chunks, lengths)
        built = TPR.cache_stats()["misses"]
        second = backend(tp, chunks, lengths)
        assert TPR.cache_stats()["misses"] == built
        assert torch.equal(first.trans, second.trans)
        TPR.clear_cache()
        TBW.fit(tp, ch, num_iters=3, convergence=0.0, backend=backend)
        assert TPR.cache_stats()["misses"] == built


# -- the sharded decode and posterior -------------------------------------------------


@pytest.mark.parametrize("engine,preset", [("xla", "durbin_cpg8"), ("onehot", "durbin_cpg8"),
                                           ("pallas", "durbin_cpg8"),
                                           ("pallas", "two_state_cpg")])
def test_viterbi_sharded_matches_jax(rng, engine, preset):
    """8 shards: paths equal to the JAX package's on 8 devices, one pass and
    in three spans, and to the port's one-entry decode (the tie contract
    holds them equal on a record without near-ties)."""
    jp, tp = _both(preset)
    obs = _stream(rng, 8 * 700 + 33)
    jpath = np.asarray(JD.viterbi_sharded(jp, obs, mesh=_jmesh(8), block_size=128,
                                          engine=engine))
    tpath = TD.viterbi_sharded(tp, obs, mesh=_tmesh(8), block_size=128, engine=engine)
    assert np.array_equal(tpath, jpath)
    jspans = JD.viterbi_sharded_spans(jp, obs, span=2000, mesh=_jmesh(8), block_size=128,
                                      engine=engine)
    tspans = TD.viterbi_sharded_spans(tp, obs, span=2000, mesh=_tmesh(8), block_size=128,
                                      engine=engine)
    assert len(tspans) == len(jspans) == 3
    for a, b in zip(tspans, jspans):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(np.concatenate(tspans), tpath)
    dev = TD.viterbi_sharded(tp, obs, mesh=_tmesh(8), block_size=128, engine=engine,
                             return_device=True)
    assert torch.equal(dev, torch.from_numpy(tpath))


@pytest.mark.parametrize("engine,preset", [("xla", "durbin_cpg8"), ("onehot", "durbin_cpg8"),
                                           ("pallas", "two_state_cpg")])
@pytest.mark.parametrize("span", ["first", "continuation"])
def test_posterior_sharded_mesh_matches_jax(rng, engine, preset, span):
    jp, tp = _both(preset)
    obs = _stream(rng, 8 * 500 + 11)
    isl = (0, 1, 2, 3) if preset == "durbin_cpg8" else (0,)
    K = tp.n_states
    kw = {}
    if span == "continuation":
        r = np.random.default_rng(4)
        e, x = r.random(K).astype(np.float32), r.random(K).astype(np.float32)
        kw = dict(first=False, enter_dir=e / e.sum(), exit_dir=x / x.sum(),
                  prev_sym=int(obs[0]))
    jconf, jpath = JPO.posterior_sharded(jp, obs, isl, mesh=_jmesh(8), block_size=128,
                                         engine=engine, want_path=True, lane_T=256, t_tile=128,
                                         **kw)
    conf, path = TPO.posterior_sharded(tp, obs, isl, mesh=_tmesh(8), block_size=128,
                                       engine=engine, want_path=True, lane_T=256, **kw)
    np.testing.assert_allclose(conf, np.asarray(jconf), atol=2e-5)
    assert np.array_equal(path, np.asarray(jpath))
    conf_only, none = TPO.posterior_sharded(tp, obs, isl, mesh=_tmesh(8), block_size=128,
                                            engine=engine, lane_T=256, **kw)
    assert none is None
    np.testing.assert_allclose(conf_only, conf, atol=2e-5)


@pytest.mark.parametrize("want_path", [False, True])
def test_posterior_sharded_stacked_mesh(rng, want_path):
    """Over 8 shards the stacked kernels' plain versions (B21, B24 per
    shard, one exchange per member): each member equal to its own sharded
    posterior bit for bit; the span transfer totals over 8 shards equal the
    JAX package's."""
    from cpgisland_tpu_torch.models import presets as TPS

    _, tp = _both()
    other = TPS.random_hmm(torch.Generator().manual_seed(3), 8, 4, partition=2)
    obs = _stream(rng, 5000)
    m = _tmesh(8)
    conf, path = TPO.posterior_sharded_stacked([tp, other], obs, [(0, 1, 2, 3), (0, 1)],
                                               want_path=want_path, mesh=m, block_size=128,
                                               lane_T=256)
    for k, (p_k, isl) in enumerate([(tp, (0, 1, 2, 3)), (other, (0, 1))]):
        c, p = TPO.posterior_sharded(p_k, obs, isl, engine="onehot", mesh=m, block_size=128,
                                     want_path=want_path, lane_T=256)
        assert np.array_equal(conf[k], c)
        assert (path is None and p is None) or np.array_equal(path[k], p)
    jp, _ = _both()
    j = JPO.transfer_total_sharded(jp, obs, mesh=_jmesh(8), block_size=128, engine="onehot")
    t = TPO.transfer_total_sharded(tp, obs, mesh=m, block_size=128, engine="onehot")
    np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-7)


def test_posterior_file_on_a_mesh_matches_one_entry(tmp_path, rng, monkeypatch):
    """posterior_file and decode_file with an 8-entry default mesh write
    the one-entry files (span-threaded records too)."""
    import io

    with open(tmp_path / "g.fa", "w") as f:
        for i, n in enumerate((3000, 40)):
            f.write(f">r{i}\n" + "".join("ACGT"[x] for x in _stream(rng, n)) + "\n")
    fa = str(tmp_path / "g.fa")
    _, tp = _both()
    want = {}
    for D in (1, 8):
        if D == 8:
            monkeypatch.setattr(TPL, "make_mesh", lambda **kw: _tmesh(8))
        isl, dec = io.StringIO(), io.StringIO()
        TPL.posterior_file(fa, tp, islands_out=isl, device="cpu", span=1200)
        TPL.decode_file(fa, tp, islands_out=dec, compat=False, device="cpu", span=1200)
        want[D] = (isl.getvalue(), dec.getvalue())
    assert want[8] == want[1] and want[1][0].count("\n") >= 1


# -- the dryrun tool ------------------------------------------------------------------------


def test_dryrun_mesh_tool(capsys):
    assert dryrun_mesh.main(["--n", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"ok": true' in out and "sp_em_step_xla" in out
