"""Whole-sequence training (SeqBackend, Seq2DBackend) in the PyTorch port vs
the JAX package, on the CPU.

The JAX backends run on a one-device mesh (the conftest's CPU mesh has 8
devices, and the default mesh would take the sharded path); their off-TPU
route is the XLA twins.  Fits are held to the JAX package's parity bounds:
logliks within rtol 1e-5, probabilities within atol 1e-5, the same
structural zeros.  The input layouts (buckets, stream shards, 2-D padding)
are integer work and equal the JAX layouts exactly.  Lanes are short
(``fb_seq.DEFAULT_LANE_T`` lowered where the port picks its own), so the
plain chains stay cheap.
"""

import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cpgisland_tpu.models import hmm as JH
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.parallel import fb_sharded as JFS
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu.utils import codec as JCO
from cpgisland_tpu_torch import cli as TCLI
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import hmm as TH
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.parallel import fb_sharded as TFS
from cpgisland_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

ITERS = 3


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("seq",))


def _mesh2d():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))


def _tp(jp):
    return params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _probs(params):
    return [np.asarray(x, np.float64) for x in (params.pi, params.A, params.B)]


def _same_model(jparams, tparams, atol=1e-5):
    for j, t in zip(_probs(jparams), _probs(tparams)):
        np.testing.assert_allclose(t, j, atol=atol)
        assert np.array_equal(t == 0, j == 0)


def _fits_agree(jr, tr):
    assert tr.iterations == jr.iterations == ITERS
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    _same_model(jr.params, tr.params)


def _stream(rng, n, gc=0.45):
    return rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]).astype(np.uint8)


# -- layouts ---------------------------------------------------------------------


def test_bucket_records_matches_jax(rng):
    sizes = [5, 3000, 70_000, 1 << 16, 2, 40_000, 200_000, 9]
    recs = [_stream(rng, n) for n in sizes]
    for kw in ({}, {"floor": 1024, "budget": 1 << 13}, {"pad_value": 7}):
        j, t = JCH.bucket_records(iter(recs), **kw), TCH.bucket_records(iter(recs), **kw)
        assert t.total == j.total and t.num_chunks == j.num_chunks
        assert t.num_groups == j.num_groups
        for a, b in zip(t.chunks + t.lengths, j.chunks + j.lengths):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        TCH.bucket_records(iter([]))


@pytest.mark.parametrize("n,shards,block", [(0, 1, 1024), (5000, 1, 1024), (4096, 1, 1024),
                                            (7777, 3, 256)])
def test_shard_sequence_matches_jax(rng, n, shards, block):
    obs = _stream(rng, n)
    for a, b in zip(TFS.shard_sequence(obs, shards, block, pad_value=4),
                    JFS.shard_sequence(obs, shards, block, pad_value=4)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,T,dp,sp,block", [(3, 1000, 1, 1, 1024), (4, 2048, 1, 1, 1024),
                                             (5, 3000, 2, 2, 512)])
def test_pad_batch2d_matches_jax(rng, n, T, dp, sp, block):
    chunks = rng.integers(0, 4, size=(n, T)).astype(np.uint8)
    lengths = rng.integers(0, T + 1, size=n).astype(np.int32)
    for a, b in zip(TFS.pad_batch2d(chunks, lengths, dp, sp, block, 4),
                    JFS.pad_batch2d(chunks, lengths, dp, sp, block, 4)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- fits against the JAX backends -----------------------------------------------


def test_seq_backend_fit_matches_jax(rng, preset="durbin_cpg8", engine="onehot"):
    jp = getattr(JP, preset)()
    chunked = TCH.frame(_stream(rng, 5000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    kw = dict(engine=engine, lane_T=512, t_tile=128)
    jr = JBW.fit(jp, jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_mesh1(), **kw))
    tr = TBW.fit(_tp(jp), chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.SeqBackend(**kw))
    _fits_agree(jr, tr)


def _records(rng):
    """Records for both Seq2D routes: one above 64 Ki (a long row, its own
    seq_stats) and two short ones in one bucket (whole records, one per
    lane of one chunked launch)."""
    return [_stream(rng, n, gc) for n, gc in ((70_000, 0.4), (1500, 0.6), (1800, 0.45))]


def test_seq2d_backend_fit_matches_jax(rng):
    jp = JP.durbin_cpg8()
    recs = _records(rng)
    bucketed = TCH.bucket_records(iter(recs), floor=1024)
    jbucketed = JCH.bucket_records(iter(recs), floor=1024)
    kw = dict(engine="onehot", lane_T=1024, t_tile=256)
    jr = JBW.fit(jp, jbucketed, num_iters=ITERS, convergence=0.0,
                 backend=JBE.Seq2DBackend(mesh=_mesh2d(), **kw))
    backend = TBE.Seq2DBackend(**kw)
    tr = TBW.fit(_tp(jp), bucketed, num_iters=ITERS, convergence=0.0, backend=backend)
    _fits_agree(jr, tr)
    routes = [route for route, _, _ in backend.prepare_streams(
        _tp(jp), *backend.place(backend.prepare(bucketed), "cpu"))]
    assert sorted(set(routes)) == ["rows", "seq"]


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for i, s in enumerate(recs):
            f.write(f">r{i} synthetic\n")
            txt = "".join("ACGT"[x] for x in s)
            for k in range(0, len(txt), 60):
                f.write(txt[k : k + 60] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def seq2d_fasta(tmp_path_factory):
    """Two records above 64 Ki (the long rows: short plain chains at a low
    DEFAULT_LANE_T) and the JAX package's model dump trained on them by
    its seq2d backend on a one-device mesh."""
    rng = np.random.default_rng(11)
    path = _write_fasta(tmp_path_factory.mktemp("seq2d") / "t.fa",
                        [_stream(rng, 66_000, 0.4), _stream(rng, 67_500, 0.55)])
    jp = JP.durbin_cpg8()
    bucketed = JCH.bucket_records((s for _, s in JCO.iter_fasta_records(path)), pad_value=4)
    jr = JBW.fit(jp, bucketed, num_iters=2, convergence=0.0,
                 backend=JBE.Seq2DBackend(mesh=_mesh2d(), engine="onehot"))
    buf = io.StringIO()
    JH.dump_text(jr.params, buf)
    return path, jr, buf.getvalue()


@pytest.fixture(scope="module")
def port_seq2d(seq2d_fasta, tmp_path_factory):
    """train_file(backend="seq2d") of the port on the same FASTA (plain
    chains at a 1 Ki DEFAULT_LANE_T): (result, its dump's text)."""
    out = tmp_path_factory.mktemp("seq2d_port") / "m.txt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
        res = TPL.train_file(seq2d_fasta[0], num_iters=2, convergence=0.0, compat=False,
                             backend="seq2d", model_out=str(out), device="cpu")
    return res, out.read_text()


def test_train_file_seq2d_writes_the_jax_dump(seq2d_fasta, port_seq2d):
    """The port's dump against the JAX package's: the same layout (lines,
    tokens per line, structural zeros), the values within the fit bound
    (atol 1e-5; logliks rtol 1e-5), and the text layer byte for byte — the
    JAX package's dump_text fed the port's trained float32 probabilities
    writes the port's file."""
    _, jr, jdump = seq2d_fasta
    res, text = port_seq2d
    np.testing.assert_allclose(res.logliks, jr.logliks, rtol=1e-5)
    assert [len(ln.split()) for ln in text.splitlines()] == \
        [len(ln.split()) for ln in jdump.splitlines()]
    _same_model(jr.params, TH.load_text(io.StringIO(text)))
    _same_model(jr.params, res.params)
    theirs = io.StringIO()
    JH.dump_text(types.SimpleNamespace(pi=res.params.pi.numpy(), A=res.params.A.numpy(),
                                       B=res.params.B.numpy(), n_states=res.params.n_states),
                 theirs)
    assert theirs.getvalue() == text


def test_cli_train_seq2d_writes_the_same_dump(seq2d_fasta, port_seq2d, tmp_path, monkeypatch,
                                              capsys):
    """The CLI with --backend seq2d --clean (and the host loop) writes
    train_file's dump byte for byte, so the JAX comparison above holds for
    it too."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    out = tmp_path / "m.txt"
    assert TCLI.main(["train", seq2d_fasta[0], "--model-out", str(out), "--iters", "2",
                      "--convergence", "0", "--clean", "--backend", "seq2d",
                      "--em-fuse", "off", "--device", "cpu"]) == 0
    assert "iters=2" in capsys.readouterr().out
    assert out.read_text() == port_seq2d[1]


# -- what raises ----------------------------------------------------------------


def test_seq2d_compat_and_multi_device_raise(seq2d_fasta):
    """compat seq2d still raises; spmd, seq and seq2d with a port mesh now
    train (they raised, naming ROADMAP A9, before the mesh was ported), a
    JAX mesh is refused with a TypeError, and engine="xla" routes the
    whole-sequence E-step to the lane path (it raised naming A2)."""
    path = seq2d_fasta[0]
    with pytest.raises(ValueError, match="compat mode has no records"):
        TPL.train_file(path, compat=True, backend="seq2d", device="cpu")
    for make in (lambda: TBE.get_backend("seq", mesh=_mesh1()),
                 lambda: TBE.SeqBackend(mesh=_mesh1()),
                 lambda: TBE.Seq2DBackend(mesh=_mesh2d())):
        with pytest.raises(TypeError):
            make()
    tp = _tp(JP.durbin_cpg8())
    ch = TCH.frame(np.random.default_rng(2).integers(0, 4, 3000).astype(np.uint8), 1024)
    fits = [TBW.fit(tp, ch, num_iters=1, convergence=0.0, backend=b) for b in (
        TBE.get_backend("spmd", mesh=make_mesh(2, axis="data", device="cpu")),
        TBE.get_backend("seq", mesh=make_mesh(2, axis="seq", device="cpu")),
        TBE.Seq2DBackend(mesh=make_mesh2d(1, 2, device="cpu", n_devices=2)))]
    assert all(f.iterations == 1 and np.isfinite(f.logliks[0]) for f in fits)
    assert isinstance(TBE.get_backend("spmd"), TBE.SpmdBackend)
    assert TBE.SeqBackend(fuse_fb=False).fuse_fb is False  # the split arm runs now
    res = TPL.train_file(path, compat=False, backend="spmd", device="cpu", num_iters=1)
    assert res.iterations == 1 and np.isfinite(res.logliks[0])
    with pytest.raises(ValueError, match="rescaled"):
        TBE.get_backend("seq", mode="log")
    with pytest.raises(ValueError, match="Bucketed"):
        TBE.SeqBackend().prepare(TCH.bucket_records(iter([np.zeros(5, np.uint8)])))
    assert TBE.SeqBackend(engine="xla")._geometry(
        tp, torch.zeros(1024, dtype=torch.uint8))[0] == "xla"


def test_seq_prep_builds_once_per_placed_input(rng):
    tp = _tp(JP.durbin_cpg8())
    backend = TBE.SeqBackend(lane_T=256)
    chunks, lengths = backend.place(backend.prepare(TCH.frame(_stream(rng, 3000), 1024)), "cpu")
    TPR.clear_cache()
    first = backend(tp, chunks, lengths)
    built = TPR.cache_stats()["misses"]
    assert built == 2  # the total length and the prep
    second = backend(tp, chunks, lengths)
    assert TPR.cache_stats()["misses"] == built and TPR.cache_stats()["hits"] >= 2
    assert all(torch.equal(getattr(first, f), getattr(second, f))
               for f in ("init", "trans", "emit", "loglik"))
    # A new placement of the same symbols is a new input: built again.
    chunks2 = chunks.clone()
    backend(tp, chunks2, lengths)
    assert TPR.cache_stats()["misses"] == built + 1
    del chunks2
    TPR.clear_cache()
