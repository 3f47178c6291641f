"""B16 in sub-lanes and B5's segment rule: the port vs the JAX package.

B16 (the dense forward chain, K <= 4) runs each lane of Tp steps as G =
``fb_pallas.fwd_sublanes(Tp, K)`` sub-lanes.  The step divides by the sum of
the alpha before it, so it is degree 0 in that alpha: a sub-lane entered
with the direction of the alpha before it (from the lane's a0 through the
earlier sub-lanes' products, scaled by powers of two) stores, in exact
arithmetic, the sequential chain's alphas; past a lane's last valid step
every alpha is that step's.  In float32 the G > 1 plain version differs from
the sequential chain in the last bits, so it is held against the JAX dense
forward in interpret mode within the bound that already covers XLA:CPU's FMA
contraction (rtol 1e-5 / atol 1e-6 of each row's scale,
tests/test_torch_fb_dense.py), with the sub-lane length set small so that a
thousand steps make several sub-lanes.  With G = 1 it is the sequential
chain bit for bit.  End to end, with the sub-lane length lowered: the
two_state posterior island file equals the JAX package's byte for byte, and
two_state ``LocalBackend`` and ``SeqBackend`` fits hold the JAX EM parity
bound.  B5's segment length is a function of the layout's shape alone.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import fb_pallas as TFP
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

from test_torch_dense_fb_pipeline import _same_model, _seq, _two_state, _write
from test_torch_fb_dense import _close_rows
from test_torch_seq_backend import ITERS, _fits_agree, _mesh1, _stream

JAX_LANES, LANES, T_TILE = 128, 12, 64


def _fwd_sublane_t(monkeypatch, sub):
    """B16 in sub-lanes of ``sub`` steps at every lane length."""
    monkeypatch.setattr(TFP, "FWD_SUBLANE_T", sub)
    monkeypatch.setattr(TFP, "FWD_SUBLANES_FROM", 1)


def _dense_model(rng, K, S):
    A = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    B = rng.dirichlet(np.ones(S), size=K).astype(np.float32)
    return A, B


def _t(x, lanes=True):
    return torch.from_numpy(np.ascontiguousarray(x[..., :LANES] if lanes else x))


def _seq_chain(steps, lens, a0, A, B):
    """The sequential forward chain of B16 (one sub-lane)."""
    return TFP._fwd_chain_plain(steps, lens, a0, A, B)


# Lane lengths against sub-lanes of 100 steps over Tp = 1024 (G = 10, the last
# of 124 steps): empty, one step, shorter than a sub-lane, exactly at a
# boundary, one past it, inside a sub-lane, the chunk length, the whole lane,
# and lengths ending in the last sub-lanes.
RAGGED = [0, 1, 37, 100, 101, 412, 1000, 1024, 205, 999, 900, 2]


@pytest.mark.parametrize("K,S", [(2, 4), (4, 3), (2, 3), (4, 4)])
def test_fwd_sublanes_plain_matches_jax(K, S, monkeypatch):
    """B16 in sub-lanes of 100 steps vs the JAX package's kernel pair in
    interpret mode, on ragged lanes: every alpha within rtol 1e-5 / atol
    1e-6 of its row's scale, past-len alphas included; the alphas from
    max(len, 1) - 1 on equal that step's bit for bit, and a lane of length
    0 or 1 stores a0 at every step."""
    rng = np.random.default_rng(300 + 10 * K + S)
    Tp, T = 1024, 1000
    A, B = _dense_model(rng, K, S)
    steps = rng.integers(0, S, size=(Tp, JAX_LANES)).astype(np.int32)
    lens = np.zeros((1, JAX_LANES), np.int32)
    lens[0, :LANES] = RAGGED
    steps[np.arange(Tp)[:, None] >= lens] = 0
    a0 = (rng.random((K, JAX_LANES)) + 0.1).astype(np.float32)
    beta0 = np.ones((K, JAX_LANES), np.float32)
    _fwd_sublane_t(monkeypatch, 100)
    assert TFP.fwd_sublanes(Tp, K) == 10
    want = np.asarray(JFP._run_fb_kernels(*(jnp.asarray(x) for x in (A, B, steps, lens, a0,
                                                                       beta0)),
                                          K, S, T_TILE, T)[0])[..., :LANES]
    got = TFP.fb_fwd(_t(steps), _t(lens), _t(a0), _t(A, False), _t(B, False))
    _close_rows(got.numpy(), want, axis=1)
    assert not torch.equal(got, _seq_chain(_t(steps), _t(lens), _t(a0), _t(A, False),
                                           _t(B, False)))  # G > 1 ran
    for n, ln in enumerate(RAGGED):
        last = max(min(ln, Tp), 1) - 1
        assert torch.equal(got[last:, :, n], got[last, :, n][None].expand(Tp - last, K))
        if ln <= 1:
            assert torch.equal(got[:, :, n], _t(a0)[:, n][None].expand(Tp, K))


@pytest.mark.parametrize("K", [2, 4])
def test_fwd_sublanes_equal_sequential_in_exact_arithmetic(K, monkeypatch):
    """The G > 1 plain version and the sequential chain agree to float32's
    last bits at every sub-lane length, an empty last sub-lane (sub-lanes
    of 7 steps: 14 of 8 over 100 steps) and lanes of 0 and 1 steps
    included."""
    rng = np.random.default_rng(K)
    A, B = (torch.from_numpy(x) for x in _dense_model(rng, K, 4))
    Tp, NL = 100, 6
    steps = torch.from_numpy(rng.integers(0, 4, size=(Tp, NL)).astype(np.int32))
    lens = torch.tensor([[100, 0, 1, 8, 9, 57]], dtype=torch.int32)
    a0 = torch.from_numpy((rng.random((K, NL)) + 0.1).astype(np.float32))
    seq = _seq_chain(steps, lens, a0, A, B)
    for sub in (7, 8, 33, 50):
        _fwd_sublane_t(monkeypatch, sub)
        assert TFP.fwd_sublanes(Tp, K) > 1
        got = TFP.fb_fwd(steps, lens, a0, A, B)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-6, atol=0)


@pytest.mark.parametrize("K", [1, 2, 4, 5, 8])
def test_fwd_one_sublane_is_the_sequential_plain(rng, monkeypatch, K):
    """G = 1 is the sequential chain bit for bit: 4 Ki lanes at the module's
    constants, a sub-lane as long as the lane, and K >= 5 at any sub-lane
    length."""
    S, Tp = 4, 4096
    A, B = (torch.from_numpy(x) for x in _dense_model(rng, K, S))
    steps = torch.from_numpy(rng.integers(0, S, size=(Tp, 6)).astype(np.int32))
    lens = torch.from_numpy(np.array([[0, 1, 17, 4000, 4096, 2222]], np.int32))
    a0 = torch.from_numpy((rng.random((K, 6)) + 0.2).astype(np.float32))
    args = (steps, lens, a0, A, B)
    seq = _seq_chain(*args)
    assert TFP.fwd_sublanes(Tp, K) == 1 and torch.equal(TFP.fb_fwd(*args), seq)
    _fwd_sublane_t(monkeypatch, 300)
    assert (TFP.fwd_sublanes(Tp, K) == 1) == (K > 4)
    if K > 4:
        assert torch.equal(TFP.fb_fwd(*args), seq)
    _fwd_sublane_t(monkeypatch, Tp)
    assert torch.equal(TFP.fb_fwd(*args), seq)


@pytest.mark.parametrize("Tp,K,sub,start,G", [
    (4096, 2, 2048, 8192, 1), (8191, 2, 2048, 8192, 1), (8192, 2, 2048, 8192, 4),
    (65536, 2, 2048, 8192, 32), (65536, 4, 4096, 8192, 16), (65536, 5, 2048, 8192, 1),
    (65536, 8, 256, 8192, 1), (8192, 1, 4096, 8192, 2), (8192, 2, 1024, 8192, 8),
    (16384, 3, 512, 8192, 32), (1024, 3, 100, 1, 10), (8, 2, 4096, 1, 1)])
def test_fwd_sublane_count(monkeypatch, Tp, K, sub, start, G):
    monkeypatch.setattr(TFP, "FWD_SUBLANE_T", sub)
    monkeypatch.setattr(TFP, "FWD_SUBLANES_FROM", start)
    assert TFP.fwd_sublanes(Tp, K) == G


def test_fwd_sublane_defaults():
    """The module's rule: sub-lanes of 512 steps from lanes of 8 Ki steps,
    32 on the training batch's 64 Ki-step lanes and 16 on the posterior
    and ``seq`` lanes, one chain below 8 Ki steps and at K >= 5."""
    assert (TFP.FWD_SUBLANE_T, TFP.FWD_SUBLANES_FROM) == (512, 8192)
    assert TFP.fwd_sublanes(TCH.TRAIN_CHUNK, 2) == 32
    assert TFP.fwd_sublanes(fb_seq.DEFAULT_LANE_T, 2) == 16
    assert TFP.fwd_sublanes(fb_seq.DEFAULT_LANE_T - 1, 2) == 1
    assert TFP.fwd_sublanes(TCH.TRAIN_CHUNK, 8) == 1


# -- B5's segments --------------------------------------------------------------------


@pytest.mark.parametrize("Tp,NL,seg,want", [
    (65536, 1024, 512, 512), (8192, 11121, 512, 512), (100, 7, 512, 100), (65536, 1024, 256, 256),
    (9, 3, 4096, 9)])
def test_stats_segment_rule(monkeypatch, Tp, NL, seg, want):
    monkeypatch.setattr(TFB, "STATS_SEGMENT_T", seg)
    assert TFB.stats_segment_t(Tp, NL) == want


def test_stats_segment_defaults():
    """The module's rule: segments of 512 steps at the training batch's
    and the ``seq`` lanes' shapes, whatever t-tile the layout has."""
    assert TFB.STATS_SEGMENT_T == 512
    assert TFB.stats_segment_t(TCH.TRAIN_CHUNK, 1390) == 512
    assert TFB.stats_segment_t(fb_seq.DEFAULT_LANE_T, 11121) == 512
    assert TFB.stats_segment_t(100, 3) == 100


@pytest.mark.parametrize("S,spb", [(1, 4), (2, 4), (4, 4), (8, 4), (16, 1)])
def test_stats_segments_per_block(S, spb):
    """Four segments a block of 128 threads where the accumulator columns
    fit (S <= 8), one (32 threads) at S = 16."""
    assert TFB.stats_segments_per_block(S) == spb


@pytest.mark.parametrize("Tp,NL,S,rows", [(65536, 1024, 4, 32), (8192, 8192, 4, 4),
                                          (4099, 33, 16, 9), (9, 3, 4, 1)])
def test_stats_part_rows(monkeypatch, Tp, NL, S, rows):
    """The partial row sets a lane leaves the reduce: ceil(ceil(Tp / Tt) /
    segments a block), Tt from the shape rule (512 here)."""
    monkeypatch.setattr(TFB, "STATS_SEGMENT_T", 512)
    assert TFB._stats_part_rows(Tp, NL, S) == rows


# -- end to end ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Records of 1.3-12 kb with GC-rich stretches."""
    rng = np.random.default_rng(14)
    sizes = [2500, 12000, 5200, 1300]
    return _write(tmp_path_factory.mktemp("fa") / "g.fa",
                  [(f"rec{r}", _seq(rng, n)) for r, n in enumerate(sizes)])


def test_two_state_posterior_file_with_fwd_sublanes_matches_jax(fasta, monkeypatch, tmp_path):
    """two_state ``posterior_file`` with a path output over 1 Ki-step lanes,
    B16 in 4 sub-lanes of 256: the JAX package's island file byte for byte,
    the confidence within atol 2e-5, the MPM path equal."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    _fwd_sublane_t(monkeypatch, 256)
    assert TFP.fwd_sublanes(1024, 2) == 4
    jp, tp = _two_state()
    want, got = io.StringIO(), io.StringIO()
    JPL.posterior_file(fasta, jp, islands_out=want, confidence_out=str(tmp_path / "j.npy"),
                       mpm_path_out=str(tmp_path / "jp.npy"), island_states=(0,),
                       engine="pallas", island_engine="host")
    TPL.posterior_file(fasta, tp, islands_out=got, confidence_out=str(tmp_path / "t.npy"),
                       mpm_path_out=str(tmp_path / "tp.npy"), island_states=(0,), device="cpu")
    assert got.getvalue() == want.getvalue() and want.getvalue().count("\n") >= 2
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"),
                               rtol=0, atol=2e-5)
    assert np.array_equal(np.load(tmp_path / "tp.npy"), np.load(tmp_path / "jp.npy"))


def test_two_state_local_fit_with_fwd_sublanes_matches_jax(rng, monkeypatch):
    """A 5-iteration two_state ``LocalBackend`` fit on 4 Ki chunks with B16
    in 8 sub-lanes of 512 holds the JAX fit within the EM parity bound:
    logliks rtol 1e-5, deltas and probabilities atol 1e-5, the same
    iterations."""
    _fwd_sublane_t(monkeypatch, 512)
    jp, tp = _two_state()
    N, T = 5, 4096
    chunks = np.stack([_seq(rng, T) for _ in range(N)]).astype(np.uint8)
    lengths = np.array([T, T, 0, 1500, T // 3], np.int32)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    total = int(lengths.sum())
    jr = JBW.fit(jp, JCH.Chunked(chunks=chunks, lengths=lengths, total=total), num_iters=5,
                 convergence=0.0, engine="pallas")
    tr = TBW.fit(tp, TCH.Chunked(chunks=chunks, lengths=lengths, total=total), num_iters=5,
                 convergence=0.0)
    assert tr.iterations == jr.iterations == 5
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    np.testing.assert_allclose(tr.deltas, jr.deltas, atol=1e-5)
    _same_model(jr.params, tr.params)


def test_two_state_seq_fit_with_fwd_sublanes_matches_jax(rng, monkeypatch):
    """two_state through ``SeqBackend`` (the dense engine, lanes of 512
    steps, B16 in 4 sub-lanes of 128) holds the JAX seq fit within the EM
    parity bound."""
    _fwd_sublane_t(monkeypatch, 128)
    assert TFP.fwd_sublanes(512, 2) == 4
    jp, tp = _two_state()
    chunked = TCH.frame(_stream(rng, 5000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    kw = dict(engine="pallas", lane_T=512, t_tile=128)
    jr = JBW.fit(jp, jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_mesh1(), **kw))
    tr = TBW.fit(tp, chunked, num_iters=ITERS, convergence=0.0, backend=TBE.SeqBackend(**kw))
    _fits_agree(jr, tr)
