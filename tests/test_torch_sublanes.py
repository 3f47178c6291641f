"""B4 / B24 in sub-lanes: the port's sub-lane chains vs the JAX package.

A lane of Tp steps runs as G = ``fb_onehot.sublanes(Tp)`` sub-lanes joined
by exact boundary messages (each sub-lane's transfer product, then a scan
over the sub-lanes).  Both chains are degree 0 in the vector they carry,
so in exact arithmetic every alpha and beta equals the sequential chain's;
in float32 they differ in the last bits.  So the G > 1 plain version is
held against the JAX package's sequential twin ``_xla_fwdbwd_onehot``
within the rtol 1e-5 that already covers XLA:CPU's FMA contraction
(tests/test_torch_fb_onehot.py), at ragged lanes: an empty lane, a
one-symbol lane, a length ending inside a sub-lane, on a sub-lane
boundary, and sub-lanes that start past the length.  The sub-lane length
``SUBLANE_T`` is set small here (3-512) so that a few thousand steps make
several sub-lanes.  With G = 1 the function is the sequential plain
version bit for bit, and a stacked member equals its own single-model run
bit for bit at any G.  End to end, a ``LocalBackend`` fit and a
``posterior_file`` run with the module's ``SUBLANE_T`` lowered hold the
JAX package's fit (its EM parity bound) and island file (byte for byte).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import prepared as JPR
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

# (lanes, chunk length, sub-lane length): G = Tp // SUBLANE_T with Tp the
# chunk length rounded up to 512 — 12 sub-lanes of 256, 6 of 342 (a last
# one of 338), 10 of 103 (a last one of 97).
GEOMS = [(10, 3000, 256), (8, 2000, 300), (5, 1000, 100)]


def _both():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _ragged(rng, N, T, sub):
    """[N, T] chunks, PAD past each length: a full lane, an empty one, a
    one-symbol one, lengths on a sub-lane boundary and one step either
    side, the rest random (most leave sub-lanes past their length)."""
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[:5] = [T, 0, 1, sub, sub + 1]
    lengths[-1] = max(2, T // 7)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    return chunks, lengths


def _inputs(rng, N, T, sub):
    _, tp = _both()
    chunks, lengths = _ragged(rng, N, T, sub)
    jprep = JPR.prepare_chunked(4, jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True)
    tprep = TPR.prepare_chunked(4, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                t_tile=512)
    tab = TFB.prob_tab_ext(tp, TOH._groups(tp))
    # Non-uniform entering and exit vectors, as a posterior span's lanes get.
    a0 = rng.random((2, N)).astype(np.float32) + 0.01
    b0 = rng.random((2, N)).astype(np.float32) + 0.01
    return jprep, tprep, tab, a0, b0


@pytest.mark.parametrize("N,T,sub", GEOMS)
def test_sublane_plain_matches_xla_twin(rng, monkeypatch, N, T, sub):
    jprep, tprep, tab, a0, b0 = _inputs(rng, N, T, sub)
    monkeypatch.setattr(TFB, "SUBLANE_T", sub)
    assert TFB.sublanes(tprep.pair2.shape[0]) > 1
    want = jax.jit(JFB._xla_fwdbwd_onehot, static_argnums=6)(
        jnp.asarray(tab.numpy()), jnp.minimum(jprep.pair2[:, :N], 16),
        jnp.minimum(jprep.pairn2[:, :N], 16), jprep.lens2[:, :N], jnp.asarray(a0.T),
        jnp.asarray(b0.T), T)
    got = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2, torch.from_numpy(a0),
                        torch.from_numpy(b0), tab, T)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # Past each length the forward carries the last valid alpha exactly,
    # and the backward carries beta0 exactly.
    al, be = got
    for n, ln in enumerate(tprep.lens2[0].tolist()):
        last = max(ln, 1) - 1
        assert torch.equal(al[last:, :, n], al[last, :, n].expand_as(al[last:, :, n]))
        lim = max(min(T - 1, ln - 1), 0)
        assert torch.equal(be[lim:, :, n], torch.from_numpy(b0[:, n]).expand_as(be[lim:, :, n]))


@pytest.mark.parametrize("N,T,sub", GEOMS)
def test_sublanes_exact_in_the_limit(rng, monkeypatch, N, T, sub):
    """The same lanes at G = 1 and at G > 1 agree to f32 rounding: the
    boundary messages carry the exact directions."""
    _, tprep, tab, a0, b0 = _inputs(rng, N, T, sub)
    args = (tprep.pair2, tprep.pairn2, tprep.lens2, torch.from_numpy(a0),
            torch.from_numpy(b0), tab, T)
    monkeypatch.setattr(TFB, "SUBLANE_T", tprep.pair2.shape[0])
    seq = TFB.oh_fwdbwd_plain(*args)
    monkeypatch.setattr(TFB, "SUBLANE_T", sub)
    sub_ = TFB.oh_fwdbwd_plain(*args)
    for s, g in zip(seq, sub_):
        torch.testing.assert_close(g, s, rtol=5e-6, atol=0)


@pytest.mark.parametrize("N,T,sub", GEOMS + [(6, 4096, 4096)])
def test_one_sublane_is_the_sequential_plain(rng, monkeypatch, N, T, sub):
    """G = 1 gives the sequential chains' bits (B9's forward and the
    self-normalized backward); 4 Ki chunks keep G = 1 at the module's
    SUBLANE_T."""
    _, tprep, tab, a0, b0 = _inputs(rng, N, T, sub)
    Tp = tprep.pair2.shape[0]
    a0, b0 = torch.from_numpy(a0), torch.from_numpy(b0)
    default = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2, a0, b0, tab, T)
    monkeypatch.setattr(TFB, "SUBLANE_T", Tp)
    al, be = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2, a0, b0, tab, T)
    assert torch.equal(al, TFB.oh_fwd_plain(tprep.pair2, tprep.lens2, a0, tab))
    assert torch.equal(be, TFB._bwd_plain(tprep.pairn2, tprep.lens2, b0, tab, T))
    if Tp <= 4096:
        assert torch.equal(default[0], al) and torch.equal(default[1], be)


@pytest.mark.parametrize("M", [2, 3])
@pytest.mark.parametrize("N,T,sub", GEOMS[:2])
def test_stacked_members_equal_single(rng, monkeypatch, M, N, T, sub):
    """B24's plain version at G > 1: every member equals its own B4 plain
    run bit for bit (one alphabet, random partition=2 members)."""
    _, tprep, tab, a0, b0 = _inputs(rng, N, T, sub)
    monkeypatch.setattr(TFB, "SUBLANE_T", sub)
    gen = torch.Generator().manual_seed(M)
    others = [TP.random_hmm(gen, 8, 4, partition=2) for _ in range(M - 1)]
    tabs = torch.stack([tab] + [TFB.prob_tab_ext(p, TOH._groups(p)) for p in others])
    A0 = torch.from_numpy(np.stack([a0] + [rng.random((2, N)).astype(np.float32) + 0.01
                                           for _ in range(M - 1)]))
    B0 = torch.from_numpy(np.stack([b0] + [rng.random((2, N)).astype(np.float32) + 0.01
                                           for _ in range(M - 1)]))
    al, be = TFB.oh_fwdbwd_stacked(tprep.pair2, tprep.pairn2, tprep.lens2, A0, B0, tabs, T)
    for m in range(M):
        a1, b1 = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2, A0[m], B0[m],
                               tabs[m].contiguous(), T)
        assert torch.equal(al[m], a1) and torch.equal(be[m], b1)


@pytest.mark.parametrize("lane_T,length,sub", [(100, 950, 3), (96, 700, 7)])
def test_posterior_lanes_with_empty_sublanes(rng, monkeypatch, lane_T, length, sub):
    """Posterior lanes (one sequence cut into lanes of lane_T steps) whose
    last sub-lanes are empty ((G - 1) * L >= lane_T): the same bound
    against the sequential twin."""
    _, tp = _both()
    obs = rng.integers(0, 4, size=length).astype(np.uint8)
    prep = TPR.prepare_seq(4, torch.from_numpy(obs), length, lane_T=lane_T)
    Tp, NL = prep.pair2.shape
    monkeypatch.setattr(TFB, "SUBLANE_T", sub)
    G = TFB.sublanes(Tp)
    L = -(-Tp // G)
    assert (G - 1) * L >= Tp  # empty trailing sub-lanes
    lens2 = prep.lane_lens[None, :].contiguous()
    tab = TFB.prob_tab_ext(tp, TOH._groups(tp))
    a0 = rng.random((2, NL)).astype(np.float32) + 0.01
    b0 = rng.random((2, NL)).astype(np.float32) + 0.01
    want = jax.jit(JFB._xla_fwdbwd_onehot, static_argnums=6)(
        jnp.asarray(tab.numpy()), jnp.asarray(torch.clamp_max(prep.pair2, 16).numpy()),
        jnp.asarray(torch.clamp_max(prep.pairn2, 16).numpy()), jnp.asarray(lens2.numpy()),
        jnp.asarray(a0.T), jnp.asarray(b0.T), lane_T)
    got = TFB.oh_fwdbwd(prep.pair2, prep.pairn2, lens2, torch.from_numpy(a0),
                        torch.from_numpy(b0), tab, lane_T)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("Tp,sub,G", [(4096, 4096, 1), (4608, 4096, 1), (8192, 4096, 2),
                                      (65536, 4096, 16), (65536, 2048, 32), (1 << 20, 4096, 32),
                                      (8, 4096, 1), (3072, 256, 12)])
def test_sublane_count(monkeypatch, Tp, sub, G):
    monkeypatch.setattr(TFB, "SUBLANE_T", sub)
    assert TFB.sublanes(Tp) == G


# -- end to end, with the module's sub-lane length lowered ----------------------


def _chunked(rng, N=6, T=4096):
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    for i in range(N):  # a GC-rich stretch per chunk
        a = T // 8
        chunks[i, a : a + T // 5] = rng.choice(4, size=T // 5, p=[0.125, 0.375, 0.375, 0.125])
    lengths = np.full(N, T, np.int32)
    lengths[-1], lengths[2] = T // 3, 0
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    total = int(lengths.sum())
    return (JCH.Chunked(chunks=chunks, lengths=lengths, total=total),
            TCH.Chunked(chunks=chunks, lengths=lengths, total=total))


def test_local_fit_matches_jax(rng, monkeypatch):
    """A 5-iteration ``LocalBackend`` fit with 512-step sub-lanes (G = 8
    on 4 Ki chunks) holds the JAX fit within the EM parity bound of
    tests/test_torch_train.py: logliks rtol 1e-5, deltas and probabilities
    atol 1e-5, the same iterations."""
    monkeypatch.setattr(TFB, "SUBLANE_T", 512)
    jp, tp = _both()
    jc, tc = _chunked(rng)
    jr = JBW.fit(jp, jc, num_iters=5, convergence=0.0, engine="onehot")
    tr = TBW.fit(tp, tc, num_iters=5, convergence=0.0)
    assert tr.iterations == jr.iterations == 5
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    np.testing.assert_allclose(tr.deltas, jr.deltas, atol=1e-5)
    for j, t in zip((jr.params.pi, jr.params.A, jr.params.B),
                    (tr.params.pi, tr.params.A, tr.params.B)):
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   atol=1e-5)
        assert np.array_equal(np.asarray(t) == 0, np.asarray(j) == 0)


def _seq(rng, n):
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
    for a in range(400, n - 900, 5000):
        s[a : a + 800] = rng.choice(4, size=800, p=[0.15, 0.35, 0.35, 0.15])
    return s


def test_posterior_file_matches_jax(rng, monkeypatch, tmp_path):
    """``posterior_file`` over 1 Ki-step lanes cut into 256-step sub-lanes
    (G = 4): the island file equals the JAX package's byte for byte, the
    confidence within its posterior pin (atol 2e-5)."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    monkeypatch.setattr(TFB, "SUBLANE_T", 256)
    path = tmp_path / "g.fa"
    with open(path, "w") as f:
        for r, n in enumerate([2500, 21000, 5200]):
            f.write(f">rec{r}\n" + "".join("ACGT"[x] for x in _seq(rng, n)) + "\n")
    jp, tp = _both()
    want, got = io.StringIO(), io.StringIO()
    JPL.posterior_file(str(path), jp, islands_out=want, confidence_out=str(tmp_path / "j.npy"),
                       engine="onehot", island_engine="host")
    TPL.posterior_file(str(path), tp, islands_out=got, confidence_out=str(tmp_path / "t.npy"),
                       device="cpu")
    assert got.getvalue() == want.getvalue() and got.getvalue().count("\n") >= 2
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"),
                               rtol=0, atol=2e-5)
