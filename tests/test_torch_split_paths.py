"""The split arm's paths of the port (``fused=False`` / ``fuse_fb=False``)
vs the JAX package's split arm, on the CPU.

The port runs the plain versions of B9-B12, B22 and B23 (and B7, B5 where
the path reaches them); the JAX package its XLA twins, with
``engine="onehot"`` (``onehot=True``) passed explicitly, since off the TPU
its routers would take the "xla" engine (ROADMAP §C).  The bounds are
``tests/test_passfusion.py``'s own: confidence within atol 2e-5, MPM paths
equal (across the two packages, except where a group's two gammas are
within 1e-5 of each other, the tie rule of ``tests/test_torch_posterior.py``),
statistics within rtol 5e-5 / atol 1e-3, logliks within rtol 1e-5 and
trained models within atol 1e-5.  Within the port the stacked split arm
equals the sequential one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu.parallel import posterior as JPO
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_chunked, fb_seq
from cpgisland_tpu_torch.parallel import posterior as TPO
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

MASK8 = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
LANE_T, T_TILE = 512, 256
ITERS = 3


def _tp(jp):
    return params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("seq",))


def _genome(rng, n):
    """Background at GC 0.41 with CpG depleted (3 of 4 CG -> CA) and a
    planted GC-rich stretch every ~3 kb."""
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295]).astype(np.uint8)
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    s[cg[rng.random(cg.size) < 0.75] + 1] = 0
    for a in range(300, n - 700, 3000):
        s[a : a + 600] = rng.choice(4, size=600, p=[0.15, 0.35, 0.35, 0.15])
    return s


def _onehot_s3():
    """A reduced model over a 3-symbol alphabet (two states per symbol):
    outside B12's power-of-two domain, so its chunked counts take the dense
    stats kernel over the scattered split streams."""
    rng = np.random.default_rng(5)
    K, S = 6, 3
    A = rng.random((K, K)) + 0.1
    A /= A.sum(1, keepdims=True)
    B = np.zeros((K, S))
    for k in range(K):
        B[k, k // 2] = 1.0
    with np.errstate(divide="ignore"):
        return JHmm(jnp.asarray(np.log(np.full(K, 1.0 / K)), jnp.float32),
                    jnp.asarray(np.log(A), jnp.float32),
                    jnp.asarray(np.maximum(np.log(B), -1e30), jnp.float32))


def _stats_close(t, j, rtol=5e-5, atol=1e-3):
    np.testing.assert_allclose(t.init.numpy(), np.asarray(j.init), atol=1e-5)
    np.testing.assert_allclose(t.trans.numpy(), np.asarray(j.trans), rtol=rtol, atol=atol)
    np.testing.assert_allclose(t.emit.numpy(), np.asarray(j.emit), rtol=rtol, atol=atol)
    assert float(t.loglik) == pytest.approx(float(j.loglik), rel=1e-5)
    assert int(t.n_seqs) == int(j.n_seqs)


def _batch(rng, N, T, S=4):
    """Seeded [N, T] records (ragged, an empty and a one-symbol row, PAD
    tails)."""
    chunks = np.stack([_genome(rng, T) % S for _ in range(N)])
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    lengths[1:3] = 0, 1
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    return chunks, lengths


def _path_equal_except_ties(j_path, t_path, g0, g1, tol=1e-5):
    diff = np.flatnonzero(np.asarray(j_path) != np.asarray(t_path))
    assert diff.size == 0 or np.all(np.abs(g0[diff] - g1[diff]) <= tol), diff[:10]


def _gammas(tp, obs, lane_T, **kw):
    """Normalized group gammas (low, high) per position, for the tie rule."""
    al2, b2, _, _ = fb_seq._lane_streams(tp, torch.from_numpy(obs), obs.size, lane_T,
                                         fused=False, **kw)
    g = (al2 * b2).permute(2, 0, 1).reshape(-1, 2)[: obs.size].double()
    g = g / g.sum(1, keepdim=True).clamp_min(1e-300)
    return g[:, 0].numpy(), g[:, 1].numpy()


# -- the chunked E-step


@pytest.mark.parametrize("N,T", [(6, 3000), (9, 1000)])
def test_batch_stats_split_matches_jax(rng, N, T):
    """``batch_stats(fused=False)`` (B9, B10, B12) vs
    ``batch_stats_pallas(onehot=True, fused=False)``, and within the same
    bounds of the port's fused arm."""
    jp = JP.durbin_cpg8()
    chunks, lengths = _batch(rng, N, T)
    sj = JFP.batch_stats_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True, fused=False)
    args = (_tp(jp), torch.from_numpy(chunks), torch.from_numpy(lengths))
    st = fb_chunked.batch_stats(*args, fused=False)
    _stats_close(st, sj)
    _stats_close(st, fb_chunked.batch_stats(*args))
    assert np.array_equal(st.emit.numpy() == 0, np.asarray(sj.emit) == 0)


def test_batch_stats_non_pow2_alphabet_matches_jax(rng):
    """A reduced model over 3 symbols: the split chains scattered to dense
    for the dense stats kernel (B20), whatever ``fused`` says, as
    ``batch_stats_pallas(onehot=True)`` does."""
    jp = _onehot_s3()
    chunks, lengths = _batch(rng, 5, 900, S=3)
    sj = JFP.batch_stats_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True)
    args = (_tp(jp), torch.from_numpy(chunks), torch.from_numpy(lengths))
    fused = fb_chunked.batch_stats(*args)
    _stats_close(fused, sj)
    split = fb_chunked.batch_stats(*args, fused=False)
    for f in ("init", "trans", "emit", "loglik", "n_seqs"):
        assert torch.equal(getattr(fused, f), getattr(split, f)), f


# -- the whole-sequence E-step and posterior


@pytest.mark.parametrize("length", [3000, 2811])
def test_seq_stats_split_matches_jax(length):
    """``seq_stats(fused=False)`` (B7, B9, B10, B5) vs
    ``seq_stats_pallas(onehot=True, fused=False)``, a full and a ragged
    last lane."""
    jp = JP.durbin_cpg8()
    obs = np.random.default_rng(length).integers(0, 4, size=3000).astype(np.uint8)
    sj = JFP.seq_stats_pallas(jp, jnp.asarray(obs), length, lane_T=256, t_tile=128,
                              onehot=True, fused=False)
    st = fb_seq.seq_stats(_tp(jp), torch.from_numpy(obs), length, lane_T=256, t_tile=128,
                          fused=False)
    _stats_close(st, sj)
    _stats_close(st, fb_seq.seq_stats(_tp(jp), torch.from_numpy(obs), length, lane_T=256,
                                      t_tile=128))


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("want_path", [False, True])
def test_seq_posterior_split_matches_jax(rng, first, want_path):
    """A first span, and a continuation span with threaded enter / exit
    directions and prev_sym, vs ``seq_posterior_pallas(onehot=True,
    fused=False)``; B11 without the path, B10 with it.  Against the port's
    fused arm: confidence within atol 2e-5, paths equal."""
    jp = JP.durbin_cpg8()
    tp = _tp(jp)
    obs = _genome(rng, 6000)
    piece = obs if first else obs[2500:]
    kw, jkw = {}, {}
    if not first:
        prev = int(obs[2499])
        enter = np.zeros(8, np.float32)
        enter[[prev, prev + 4]] = rng.random(2) + 0.1
        last = int(piece[-1])
        exit_ = np.zeros(8, np.float32)
        exit_[[last, last + 4]] = rng.random(2) + 0.1
        kw = dict(enter_dir=enter, exit_dir=exit_, first=False, prev_sym=prev)
        jkw = dict(enter_dir=jnp.asarray(enter), exit_dir=jnp.asarray(exit_), first=False,
                   prev_sym=jnp.int32(prev))
    c_j, p_j = JFP.seq_posterior_pallas(jp, jnp.asarray(piece), piece.size,
                                        jnp.asarray(MASK8), want_path=want_path,
                                        lane_T=LANE_T, t_tile=T_TILE, onehot=True,
                                        fused=False, **jkw)
    c_t, p_t = fb_seq.seq_posterior(tp, torch.from_numpy(piece), piece.size, MASK8,
                                    want_path=want_path, lane_T=LANE_T, fused=False, **kw)
    c_f, p_f = fb_seq.seq_posterior(tp, torch.from_numpy(piece), piece.size, MASK8,
                                    want_path=want_path, lane_T=LANE_T, **kw)
    assert np.all(np.isfinite(c_t.numpy()))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(c_t.numpy(), c_f.numpy(), rtol=0, atol=2e-5)
    assert torch.equal(p_t, p_f)
    if want_path:
        g0, g1 = _gammas(tp, piece, LANE_T, **kw)
        _path_equal_except_ties(p_j, p_t.numpy(), g0, g1)
        assert np.any(p_t.numpy() < 4) and np.any(p_t.numpy() >= 4)
    else:
        assert not p_t.any()


@pytest.mark.parametrize("want_path", [False, True])
def test_batch_posterior_split_matches_jax(rng, want_path):
    """Independent records, one per lane (ragged, an empty row), vs
    ``batch_posterior_pallas(onehot=True, fused=False)``."""
    jp = JP.durbin_cpg8()
    chunks, lengths = _batch(rng, 6, 3000)
    c_j, p_j = JFP.batch_posterior_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                          jnp.asarray(MASK8), want_path=want_path,
                                          onehot=True, fused=False)
    c_t, p_t = fb_seq.batch_posterior(_tp(jp), torch.from_numpy(chunks),
                                      torch.from_numpy(lengths), MASK8, want_path=want_path,
                                      fused=False)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=2e-5)
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("want_path", [False, True])
def test_posterior_sharded_split_matches_jax(rng, want_path):
    """``posterior_sharded(fused=False)`` vs the JAX package's on a
    one-device mesh, the record in lanes of 512."""
    jp = JP.durbin_cpg8()
    obs = _genome(rng, 5000)
    isl = (0, 1, 2, 3)
    c_j, p_j = JPO.posterior_sharded(jp, obs, isl, mesh=_mesh1(), engine="onehot",
                                     lane_T=LANE_T, want_path=want_path, fused=False)
    c_t, p_t = TPO.posterior_sharded(_tp(jp), obs, isl, engine="onehot", lane_T=LANE_T,
                                     want_path=want_path, fused=False)
    np.testing.assert_allclose(c_t, np.asarray(c_j)[: obs.size], rtol=0, atol=2e-5)
    if want_path:
        g0, g1 = _gammas(_tp(jp), obs, LANE_T)
        _path_equal_except_ties(np.asarray(p_j)[: obs.size], p_t, g0, g1)
    else:
        assert p_t is None


# -- training


def _fits_agree(jr, tr):
    assert tr.iterations == jr.iterations == ITERS
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    for f in ("pi", "A", "B"):
        j = np.asarray(getattr(jr.params, f), np.float64)
        t = getattr(tr.params, f).double().numpy()
        np.testing.assert_allclose(t, j, atol=1e-5)
        assert np.array_equal(t == 0, j == 0)


def _stream(rng, n):
    return _genome(rng, n)


def test_local_backend_split_fit_matches_jax(rng):
    """A 3-iteration fit through ``LocalBackend(fuse_fb=False)`` vs the JAX
    package's, and within rtol 1e-5 of the port's fused fit."""
    jp = JP.durbin_cpg8()
    chunked = TCH.frame(_stream(rng, 9000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    jr = JBW.fit(jp, jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.LocalBackend(engine="onehot", fuse_fb=False))
    tr = TBW.fit(_tp(jp), chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.LocalBackend(engine="onehot", fuse_fb=False))
    _fits_agree(jr, tr)
    tf = TBW.fit(_tp(jp), chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.LocalBackend(engine="onehot"))
    np.testing.assert_allclose(tr.logliks, tf.logliks, rtol=1e-5)
    # The device loop and the host loop agree bit for bit on the split arm.
    th = TBW.fit(_tp(jp), chunked, num_iters=ITERS, convergence=0.0, fuse=False,
                 backend=TBE.LocalBackend(engine="onehot", fuse_fb=False))
    assert th.logliks == tr.logliks


def test_seq_backend_split_fit_matches_jax(rng):
    """A 3-iteration fit through ``SeqBackend(fuse_fb=False)`` (B7, B9, B10,
    B5) vs the JAX package's on a one-device mesh."""
    jp = JP.durbin_cpg8()
    chunked = TCH.frame(_stream(rng, 5000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    kw = dict(engine="onehot", lane_T=512, t_tile=128, fuse_fb=False)
    jr = JBW.fit(jp, jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_mesh1(), **kw))
    tr = TBW.fit(_tp(jp), chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.SeqBackend(**kw))
    _fits_agree(jr, tr)


# -- the stacked split arm


def _members(M, seed):
    jps = [JP.durbin_cpg8()] + [JP.random_hmm(jax.random.PRNGKey(seed + m), 8, 4, partition=2)
                                for m in range(1, M)]
    return jps, [_tp(p) for p in jps]


def test_family_estep_split_stacked_equals_sequential(rng):
    """``FamilyEStep(fuse_fb=False)``: the stacked arm (B22, B23, B12 per
    member) equals the sequential one and ``LocalBackend(fuse_fb=False)``
    per member bit for bit."""
    _, tps = _members(3, 21)
    chunks, lengths = _batch(rng, 6, 900)
    ch, ln = torch.from_numpy(chunks), torch.from_numpy(lengths)
    solo = []
    for p in tps:
        backend = TBE.LocalBackend(engine="onehot", fuse_fb=False)
        solo.append(backend(p, ch, ln, prepared=backend.prepare_streams(p, ch, ln)))
    runs = [fb_chunked.batch_stats_stacked(tps, ch, ln, fused=False)]
    for stacked in (True, False):
        estep = TBE.FamilyEStep(stacked=stacked, fuse_fb=False)
        runs.append(estep(tps, ch, ln, prepared=estep.prepare_streams(tps, ch, ln)))
    for got in runs:
        for g, w in zip(got, solo):
            for f in ("init", "trans", "emit", "loglik", "n_seqs"):
                assert torch.equal(getattr(g, f), getattr(w, f)), f


def test_fit_family_split_matches_jax(rng):
    """``fit_family(estep=FamilyEStep(fuse_fb=False))`` vs the JAX
    package's: logliks within rtol 1e-5, models within atol 1e-5."""
    jps, tps = _members(3, 41)
    chunked = TCH.frame(_stream(rng, 7000), 2048)
    jfit, jhist = JBE.fit_family(jps, jnp.asarray(chunked.chunks), jnp.asarray(chunked.lengths),
                                 n_iter=ITERS, estep=JBE.FamilyEStep(fuse_fb=False))
    tfit, thist = TBE.fit_family(tps, chunked.chunks, chunked.lengths, n_iter=ITERS,
                                 estep=TBE.FamilyEStep(fuse_fb=False))
    np.testing.assert_allclose(thist, np.asarray(jhist), rtol=1e-5)
    for j, t in zip(jfit, tfit):
        for f in ("pi", "A", "B"):
            np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                       atol=1e-5)


@pytest.mark.parametrize("want_path", [False, True])
def test_posterior_sharded_stacked_split(rng, monkeypatch, want_path):
    """``posterior_sharded_stacked(fused=False)`` (B21, B22, B23) equals M
    ``posterior_sharded(fused=False)`` calls bit for bit on a shared placed
    stream, and the JAX package's stacked split posterior within atol
    2e-5."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", LANE_T)
    jps, tps = _members(2, 11)
    obs = _genome(rng, 4000)
    states = [(0, 1, 2, 3), (0, 3, 6)]
    placed = TPO.place_record_span(tps[0], obs, pad_to=1 << 13)
    conf, path = TPO.posterior_sharded_stacked(tps, obs, states, want_path=want_path,
                                               placed=placed, fused=False)
    for m, p in enumerate(tps):
        c1, p1 = TPO.posterior_sharded(p, obs, states[m], engine="onehot",
                                       want_path=want_path, placed=placed, fused=False)
        np.testing.assert_array_equal(conf[m], c1)
        if want_path:
            np.testing.assert_array_equal(path[m], p1)
    c_j, _ = JPO.posterior_sharded_stacked(jps, obs, states, mesh=_mesh1(), lane_T=LANE_T,
                                           want_path=want_path, fused=False)
    for m in range(2):
        np.testing.assert_allclose(conf[m], np.asarray(c_j[m])[: obs.size], rtol=0, atol=2e-5)
