"""B7 / B21 and B18 in sub-lanes: the port's sub-lane chains vs the JAX package.

B7 (the reduced lane products) runs each lane of Tp steps as G =
``fb_onehot.prod_sublanes(Tp)`` sub-lanes whose products, renormalized every
8 steps, compose in order; the product is associative, so its direction
(all its consumers read) is the one chain's in exact arithmetic.  B18 (the
dense backward chain, K <= 4) runs each lane as G = ``fb_pallas.
bwd_sublanes(Tp, K)`` sub-lanes joined by boundary messages that carry the
betas' true magnitude: each sub-lane's transfer matrix is scaled by powers
of two (exact) and the exponents summed in an int.  In float32 both differ
from the sequential chains in the last bits, so the G > 1 plain versions are
held against the JAX package within the bounds that already cover XLA:CPU's
FMA contraction: B7 against ``_xla_products_prob`` (rtol 1e-5 / atol 2e-6,
tests/test_torch_posterior.py), B18 against the JAX dense backward in
interpret mode (rtol 1e-5 / atol 1e-6 of each row's scale,
tests/test_torch_fb_dense.py), at ragged lanes, with the sub-lane lengths
set small so that a few thousand steps make several sub-lanes.  A B18 lane
whose sub-lane products leave float32's range unscaled stays finite and
within the bound.  With G = 1 each is its sequential plain version bit for
bit; a B21 member equals its own B7 at every G; B19 takes B18's betas in
B18's layout.  End to end, with the sub-lane lengths lowered: posterior
island files equal the JAX package's byte for byte (the flagship through
B7, two_state through B18 and, confidence only, through B19), and a
two_state ``LocalBackend`` fit and a flagship ``SeqBackend`` fit hold the
JAX EM parity bound.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu.ops import viterbi_pallas as JVP
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import fb_pallas as TFP
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

from test_torch_dense_fb_pipeline import _same_model, _seq, _two_state, _write
from test_torch_fb_dense import _close_rows
from test_torch_seq_backend import ITERS, _fits_agree, _mesh1, _stream, _tp


def _flagship():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


# -- B7 / B21 ------------------------------------------------------------------------

# (steps, lanes, sub-lane length): 12 sub-lanes of 250, 6 of 334 (a last one
# of 330), 14 of 8 (the last one empty: 13 x 8 >= 100).
PROD_GEOMS = [(3000, 9, 250), (2000, 6, 300), (100, 5, 7)]


def _pairs(rng, Tp, NL):
    """A pair stream with PAD pairs scattered, a PAD run, a lane all PAD
    and a lane PAD past a third of its steps (a ragged record end)."""
    pair = rng.integers(0, 16, size=(Tp, NL)).astype(np.int32)
    pad = rng.random((Tp, NL)) < 0.1
    pair[pad] = 16 + rng.integers(0, 4, size=int(pad.sum()))
    pair[Tp // 2 : Tp // 2 + 60, 0] = 17
    pair[:, 1] = 18
    pair[Tp // 3 :, 2] = 16
    return pair


def _one_chain(pair2, tab):
    """The one-chain product as B7 ran it before its sub-lanes: C <- C . T_t,
    every entry over the total ((C00 + C01) + C10) + C11 each step."""
    T = tab[torch.clamp_max(pair2, tab.shape[0] - 1).long()]
    c = [torch.ones(pair2.shape[1]), torch.zeros(pair2.shape[1]),
         torch.zeros(pair2.shape[1]), torch.ones(pair2.shape[1])]
    for t in T.unbind(0):
        a00, a01, a10, a11 = t.unbind(1)
        n = (c[0] * a00 + c[1] * a10, c[0] * a01 + c[1] * a11,
             c[2] * a00 + c[3] * a10, c[2] * a01 + c[3] * a11)
        tot = torch.clamp_min(((n[0] + n[1]) + n[2]) + n[3], 1e-30)
        c = [x / tot for x in n]
    return torch.stack(c)


@pytest.mark.parametrize("Tp,NL,sub", PROD_GEOMS)
def test_prod_sublanes_plain_matches_xla_twin(rng, monkeypatch, Tp, NL, sub):
    """The G > 1 plain version of B7 through ``products_reduced`` vs the
    JAX twin: directions within rtol 1e-5 / atol 2e-6, each lane's product
    summing to 1."""
    jp, tp = _flagship()
    monkeypatch.setattr(TFB, "PROD_SUBLANES_FROM", 1)
    monkeypatch.setattr(TFB, "PROD_SUBLANE_T", sub)
    assert TFB.prod_sublanes(Tp) > 1
    pair = _pairs(rng, Tp, NL)
    want = jax.jit(JFB._xla_products_prob)(JFB.prob_pair_table(jp, JOH._groups(jp)),
                                           jnp.asarray(pair))
    got = TFB.products_reduced(tp, torch.from_numpy(pair))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-6)
    # The all-PAD lane is the identity's direction exactly.
    assert torch.equal(got[1], torch.tensor([[0.5, 0.0], [0.0, 0.5]]))


@pytest.mark.parametrize("Tp,sub", [(4096, None), (4608, None), (8191, None), (3000, 3000)])
def test_prod_one_sublane_is_the_sequential_plain(rng, monkeypatch, Tp, sub):
    """G = 1 is the one-chain product bit for bit: lanes below 8 Ki steps at
    the module's constants (the CPU tests' lanes), or a sub-lane as long
    as the lane."""
    if sub is not None:
        monkeypatch.setattr(TFB, "PROD_SUBLANES_FROM", 1)
        monkeypatch.setattr(TFB, "PROD_SUBLANE_T", sub)
    assert TFB.prod_sublanes(Tp) == 1
    _, tp = _flagship()
    tab = TFB.prob_tab_ext(tp, TOH._groups(tp))
    pair = torch.from_numpy(_pairs(rng, Tp, 4))
    assert torch.equal(TFB.oh_prod(pair, tab), _one_chain(pair, tab))


@pytest.mark.parametrize("M", [2, 3])
@pytest.mark.parametrize("sub", [None, 250, 7])
def test_prod_stacked_member_equals_single(rng, monkeypatch, M, sub):
    """B21's plain version: every member equals its own B7 plain run bit
    for bit, in one chain (``sub`` None) and in sub-lanes."""
    if sub is not None:
        monkeypatch.setattr(TFB, "PROD_SUBLANES_FROM", 1)
        monkeypatch.setattr(TFB, "PROD_SUBLANE_T", sub)
    _, tp = _flagship()
    gen = torch.Generator().manual_seed(M)
    members = [tp] + [TP.random_hmm(gen, 8, 4, partition=2) for _ in range(M - 1)]
    tabs = torch.stack([TFB.prob_tab_ext(p, TOH._groups(p)) for p in members])
    pair = torch.from_numpy(_pairs(rng, 1200, 5))
    red = TFB.oh_prod_stacked(pair, tabs)
    for m in range(M):
        assert torch.equal(red[m], TFB.oh_prod(pair, tabs[m].contiguous()))


@pytest.mark.parametrize("Tp,sub,start,G", [
    (4096, 512, 8192, 1), (4608, 512, 8192, 1), (8191, 512, 8192, 1), (8192, 512, 8192, 16),
    (8192, 256, 8192, 32), (65536, 512, 8192, 32), (3000, 250, 1, 12), (100, 7, 1, 14),
    (100, 7, 101, 1), (8, 512, 1, 1)])
def test_prod_sublane_count(monkeypatch, Tp, sub, start, G):
    monkeypatch.setattr(TFB, "PROD_SUBLANE_T", sub)
    monkeypatch.setattr(TFB, "PROD_SUBLANES_FROM", start)
    assert TFB.prod_sublanes(Tp) == G


def test_prod_sublane_defaults():
    """The module's rule: 16 sub-lanes of 512 steps on the posterior and
    ``seq`` lanes of 8 Ki steps, one chain below."""
    assert (TFB.PROD_SUBLANE_T, TFB.PROD_SUBLANES_FROM) == (512, 8192)
    assert TFB.prod_sublanes(fb_seq.DEFAULT_LANE_T) == 16
    assert TFB.prod_sublanes(fb_seq.DEFAULT_LANE_T - 1) == 1


# -- B18 -----------------------------------------------------------------------------

JAX_LANES, LANES, T_TILE = 128, 9, 64


def _bwd_sublane_t(monkeypatch, sub):
    """B18 in sub-lanes of ``sub`` steps at every lane length."""
    monkeypatch.setattr(TFP, "BWD_SUBLANE_T", sub)
    monkeypatch.setattr(TFP, "BWD_SUBLANES_FROM", 1)


def _dense_model(rng, K, S):
    A = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    B = rng.dirichlet(np.ones(S), size=K).astype(np.float32)
    return A, B


def _t(x, lanes=True):
    return torch.from_numpy(np.ascontiguousarray(x[..., :LANES] if lanes else x))


def _jax_bwd(A, B, steps_next, lens2, cs_next, beta0, T):
    """The JAX package's dense backward kernel (``_bwd_kernel``) in interpret
    mode on given time-shifted streams, laid out as ``_run_fb_kernels``
    lays it out."""
    K, S = B.shape
    Tp, NL = steps_next.shape
    n_t, lt = Tp // T_TILE, JFP._fb_lane_tile(NL)
    rev = JVP._vspec((T_TILE, lt), lambda i, j: (n_t - 1 - j, i))
    (betas,) = pl.pallas_call(
        functools.partial(JFP._bwd_kernel, K=K, S=S, Tt=T_TILE, T=T),
        grid=(NL // lt, n_t),
        in_specs=[rev, JVP._vspec((1, lt), lambda i, j: (0, i)),
                  JVP._vspec((K, K), lambda i, j: (0, 0)), JVP._vspec((K, S), lambda i, j: (0, 0)),
                  rev, JVP._vspec((K, lt), lambda i, j: (0, i))],
        out_specs=[JVP._vspec((T_TILE, K, lt), lambda i, j: (n_t - 1 - j, 0, i))],
        out_shape=[jax.ShapeDtypeStruct((Tp, K, NL), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((K, lt), jnp.float32)],
        interpret=True,
    )(*(jnp.asarray(x) for x in (steps_next, lens2, A, B, cs_next, beta0)))
    return np.asarray(betas)[..., :LANES]


@pytest.mark.parametrize("K,S", [(2, 4), (4, 3)])
def test_bwd_sublanes_plain_matches_jax(K, S, monkeypatch):
    """B16 then B18 in sub-lanes of 100 steps (G = 10, the last of 97) vs
    the JAX package's kernel pair in interpret mode, on ragged lanes: an
    empty lane, a one-step lane, lengths on a sub-lane boundary, one step
    past it, inside a sub-lane, at the chunk length and past it, and lanes
    whose last sub-lanes lie wholly past their length."""
    rng = np.random.default_rng(100 + K)
    Tp, T = 1024, 1000
    A, B = _dense_model(rng, K, S)
    steps = rng.integers(0, S, size=(Tp, JAX_LANES)).astype(np.int32)
    lens = np.zeros((1, JAX_LANES), np.int32)
    lens[0, :LANES] = [0, 1, 100, 101, 412, T, Tp, 205, 37]
    steps[np.arange(Tp)[:, None] >= lens] = 0
    a0 = (rng.random((K, JAX_LANES)) + 0.1).astype(np.float32)
    beta0 = (rng.random((K, JAX_LANES)) + 0.5).astype(np.float32)
    _bwd_sublane_t(monkeypatch, 100)
    assert TFP.bwd_sublanes(Tp, K) == 10
    want = JFP._run_fb_kernels(*(jnp.asarray(x) for x in (A, B, steps, lens, a0, beta0)), K, S,
                               T_TILE, T)
    want = [np.asarray(x)[..., :LANES] for x in want]
    got = TFP._run_fb_kernels(_t(A, False), _t(B, False), _t(steps), _t(lens), _t(a0),
                              _t(beta0), T)
    _close_rows(got[0].numpy(), want[0], axis=1)
    _close_rows(got[2].numpy(), want[2], axis=1)
    # Where no step is valid (t >= min(T - 1, len - 1)) beta0 is carried
    # exactly: the last valid sub-lane starts from beta0 itself.
    be = got[2]
    for n, ln in enumerate(lens[0, :LANES].tolist()):
        lim = max(min(T - 1, ln - 1), 0)
        assert torch.equal(be[lim:, :, n], _t(beta0)[:, n].expand_as(be[lim:, :, n]))


def _drift_streams(rng, K, S, Tp, sub, growth):
    """Time-shifted streams whose backward betas drift by 2^growth[g] over
    sub-lane g of ``sub`` steps (t walking down): cs_next[t] is the float64
    self-normalized chain's normalizer over the step's factor, so the betas
    move between 2^-100 and 2^100 while each sub-lane's unscaled transfer
    matrix grows or shrinks by 2^|growth| and can leave float32's range."""
    A, B = _dense_model(rng, K, S)
    steps = rng.integers(0, S, size=(Tp, JAX_LANES)).astype(np.int32)
    beta0 = (rng.random((K, JAX_LANES)) + 0.5).astype(np.float32)
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    d = beta0.astype(np.float64) / beta0.sum(0)
    cs = np.ones((Tp, JAX_LANES))
    for t in range(Tp - 2, -1, -1):  # t <= T - 2 with T = Tp
        raw = A64 @ (B64[:, steps[t]] * d)
        norm = raw.sum(0)
        d = raw / norm
        cs[t] = norm / 2.0 ** (growth[t // sub] / sub)
    return A, B, steps, cs.astype(np.float32), beta0


@pytest.mark.parametrize("K,S", [(2, 4), (4, 3)])
def test_bwd_power_of_two_scaling_keeps_range(K, S, monkeypatch):
    """Three sub-lanes of 1,024 steps whose betas fall by 2^100, rise by
    2^200 and fall by 2^100 walking down: the middle sub-lane's unscaled
    transfer matrix overflows float32, yet the scaled messages carry the
    true magnitudes — every beta finite and within the JAX kernel's bound,
    the betas spanning 2^-90 to 2^90."""
    rng = np.random.default_rng(200 + K)
    Tp, sub = 3072, 1024
    A, B, steps, cs, beta0 = _drift_streams(rng, K, S, Tp, sub, (-100, 200, -100))
    lens = np.full((1, JAX_LANES), Tp, np.int32)
    lens[0, 4] = 3000  # a length ending inside the last sub-lane
    _bwd_sublane_t(monkeypatch, sub)
    assert TFP.bwd_sublanes(Tp, K) == 3
    # The middle sub-lane's product, unscaled, in float64.
    Q = np.eye(K)
    for t in range(2 * sub - 1, sub - 1, -1):
        Q = (A.astype(np.float64) * (B[:, steps[t, 0]] / cs[t, 0])[None, :]) @ Q
    assert np.log2(np.abs(Q).max()) > 140
    want = _jax_bwd(A, B, steps, lens, cs, beta0, Tp)
    got = TFP.fb_bwd(_t(steps), _t(lens), _t(cs), _t(beta0), _t(A, False), _t(B, False),
                     Tp).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert got.max() > 2.0**90 and got[got > 0].min() < 2.0**-90
    _close_rows(got, want, axis=1)


@pytest.mark.parametrize("K", [1, 2, 4, 5, 8])
def test_bwd_one_sublane_is_the_sequential_plain(rng, monkeypatch, K):
    """G = 1 is the sequential chain bit for bit: 4 Ki lanes at the module's
    constants, a sub-lane as long as the lane, and K >= 5 at any
    sub-lane length."""
    S, Tp, T = 4, 4096, 4000
    A, B = (torch.from_numpy(x) for x in _dense_model(rng, K, S))
    sn = torch.from_numpy(rng.integers(0, S, size=(Tp, 6)).astype(np.int32))
    lens = torch.from_numpy(np.array([[0, 1, 17, 4000, 4096, 2222]], np.int32))
    cs = torch.from_numpy((rng.random((Tp, 6)) + 0.2).astype(np.float32))
    b0 = torch.from_numpy((rng.random((K, 6)) + 0.5).astype(np.float32))
    args = (sn, lens, cs, b0, A, B, T)
    seq = TFP._bwd_chain_plain(*args)
    assert TFP.bwd_sublanes(Tp, K) == 1 and torch.equal(TFP.fb_bwd(*args), seq)
    _bwd_sublane_t(monkeypatch, 300)
    assert (TFP.bwd_sublanes(Tp, K) == 1) == (K > 4)
    if K > 4:
        assert torch.equal(TFP.fb_bwd(*args), seq)
    _bwd_sublane_t(monkeypatch, Tp)
    assert torch.equal(TFP.fb_bwd(*args), seq)


def test_bwd_conf_keeps_the_sequential_chain(rng, monkeypatch):
    """B19 runs in B18's layout: its plain version is the confidence
    epilogue over B18's betas, the sub-lane betas at G > 1 (K = 2, 10
    sub-lanes of 100 steps; in the last bits not the sequential chain's)
    and the sequential chain's at K >= 5 (state-split, one chain whatever
    the sub-lane length)."""
    S, Tp, NL = 4, 1024, 5
    lens = torch.from_numpy(np.array([[1024, 0, 1, 600, 1000]], np.int32))
    _bwd_sublane_t(monkeypatch, 100)
    for K, G in ((2, 10), (5, 1), (8, 1)):
        A, B = (torch.from_numpy(x) for x in _dense_model(rng, K, S))
        sn = torch.from_numpy(rng.integers(0, S, size=(Tp, NL)).astype(np.int32))
        cs = torch.from_numpy((rng.random((Tp, NL)) + 0.2).astype(np.float32))
        b0 = torch.from_numpy((rng.random((K, NL)) + 0.5).astype(np.float32))
        al = torch.from_numpy(rng.random((Tp, K, NL)).astype(np.float32))
        mask = torch.from_numpy((np.arange(K) < (K + 1) // 2).astype(np.float32))
        assert TFP.bwd_sublanes(Tp, K) == G
        seq = TFP._bwd_chain_plain(sn, lens, cs, b0, A, B, 1000)
        betas = TFP._bwd_sublanes_plain(sn, lens, cs, b0, A, B, 1000, G) if G > 1 else seq
        want = TFP.conf_from_streams(al, betas, lens, mask)
        got = TFP.fb_bwd_conf(sn, lens, cs, b0, al, mask, A, B, 1000)
        assert torch.equal(got, want)
        assert torch.equal(TFP.fb_bwd_conf_plain(sn, lens, cs, b0, al, mask, A, B, 1000), want)
        if G > 1:  # the sub-lane betas are not the sequential chain's bits
            assert not torch.equal(betas, seq)
            np.testing.assert_allclose(got.numpy(), TFP.conf_from_streams(
                al, seq, lens, mask).numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("Tp,K,sub,start,G", [
    (4096, 2, 2048, 8192, 1), (8191, 2, 2048, 8192, 1), (8192, 2, 2048, 8192, 4),
    (65536, 2, 2048, 8192, 32), (65536, 4, 4096, 8192, 16), (65536, 5, 2048, 8192, 1),
    (65536, 8, 2048, 8192, 1), (8192, 1, 4096, 8192, 2), (8192, 2, 1024, 8192, 8),
    (16384, 3, 1024, 8192, 16), (1024, 3, 100, 1, 10),
    (8, 2, 4096, 1, 1)])
def test_bwd_sublane_count(monkeypatch, Tp, K, sub, start, G):
    monkeypatch.setattr(TFP, "BWD_SUBLANE_T", sub)
    monkeypatch.setattr(TFP, "BWD_SUBLANES_FROM", start)
    assert TFP.bwd_sublanes(Tp, K) == G


def test_bwd_sublane_defaults():
    """The module's rule: sub-lanes of 1 Ki steps, 32 on the training
    batch's 64 Ki-step lanes and 8 on the posterior and ``seq`` lanes of 8
    Ki steps, one chain below 8 Ki steps and at K >= 5."""
    assert (TFP.BWD_SUBLANE_T, TFP.BWD_SUBLANES_FROM) == (1024, 8192)
    assert TFP.bwd_sublanes(TCH.TRAIN_CHUNK, 2) == 32
    assert TFP.bwd_sublanes(fb_seq.DEFAULT_LANE_T, 2) == 8
    assert TFP.bwd_sublanes(fb_seq.DEFAULT_LANE_T - 1, 2) == 1
    assert TFP.bwd_sublanes(TCH.TRAIN_CHUNK, 8) == 1


# -- end to end ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Records of 1.3-12 kb with GC-rich stretches."""
    rng = np.random.default_rng(13)
    sizes = [2500, 12000, 5200, 1300]
    return _write(tmp_path_factory.mktemp("fa") / "g.fa",
                  [(f"rec{r}", _seq(rng, n)) for r, n in enumerate(sizes)])


def test_flagship_posterior_file_with_prod_sublanes_matches_jax(fasta, monkeypatch, tmp_path):
    """``posterior_file`` over 1 Ki-step lanes, B7 in 8 sub-lanes of 128:
    the JAX package's island file byte for byte, the confidence within its
    posterior pin (atol 2e-5)."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    monkeypatch.setattr(TFB, "PROD_SUBLANES_FROM", 1)
    monkeypatch.setattr(TFB, "PROD_SUBLANE_T", 128)
    assert TFB.prod_sublanes(1024) == 8
    jp, tp = _flagship()
    want, got = io.StringIO(), io.StringIO()
    JPL.posterior_file(fasta, jp, islands_out=want, confidence_out=str(tmp_path / "j.npy"),
                       engine="onehot", island_engine="host")
    TPL.posterior_file(fasta, tp, islands_out=got, confidence_out=str(tmp_path / "t.npy"),
                       device="cpu")
    assert got.getvalue() == want.getvalue() and want.getvalue().count("\n") >= 2
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"),
                               rtol=0, atol=2e-5)


def test_two_state_posterior_file_with_bwd_sublanes_matches_jax(fasta, monkeypatch, tmp_path):
    """two_state ``posterior_file`` with a path output (so the backward is
    B18, not B19) over 1 Ki-step lanes, B18 in 4 sub-lanes of 256: the JAX
    package's island file byte for byte, the confidence within atol 2e-5,
    the MPM path equal."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    _bwd_sublane_t(monkeypatch, 256)
    assert TFP.bwd_sublanes(1024, 2) == 4
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


def test_two_state_confidence_only_posterior_file_with_bwd_sublanes_matches_jax(
        fasta, monkeypatch, tmp_path):
    """two_state ``posterior_file`` asked for the confidence alone (so the
    backward is B19, never B18) over 1 Ki-step lanes, B19 in B18's 4
    sub-lanes of 256: the JAX package's island file byte for byte (its
    sequential betas), the confidence within atol 2e-5 of JAX and within
    1e-6 of the port's own run with a path output (B18's betas, a division
    where B19 multiplies by a reciprocal)."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    _bwd_sublane_t(monkeypatch, 256)
    assert TFP.bwd_sublanes(1024, 2) == 4
    jp, tp = _two_state()
    want, got = io.StringIO(), io.StringIO()
    JPL.posterior_file(fasta, jp, islands_out=want, confidence_out=str(tmp_path / "j.npy"),
                       island_states=(0,), engine="pallas", island_engine="host")
    TPL.posterior_file(fasta, tp, islands_out=got, confidence_out=str(tmp_path / "t.npy"),
                       island_states=(0,), device="cpu")
    assert got.getvalue() == want.getvalue() and want.getvalue().count("\n") >= 2
    conf = np.load(tmp_path / "t.npy")
    np.testing.assert_allclose(conf, np.load(tmp_path / "j.npy"), rtol=0, atol=2e-5)
    TPL.posterior_file(fasta, tp, islands_out=io.StringIO(),
                       confidence_out=str(tmp_path / "tp.npy"),
                       mpm_path_out=str(tmp_path / "tpath.npy"), island_states=(0,),
                       device="cpu")
    np.testing.assert_allclose(conf, np.load(tmp_path / "tp.npy"), rtol=0, atol=1e-6)


def test_two_state_local_fit_with_bwd_sublanes_matches_jax(rng, monkeypatch):
    """A 5-iteration two_state ``LocalBackend`` fit on 4 Ki chunks with B18
    in 8 sub-lanes of 512 holds the JAX fit within the EM parity bound:
    logliks rtol 1e-5, deltas and probabilities atol 1e-5, the same
    iterations."""
    _bwd_sublane_t(monkeypatch, 512)
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


def test_flagship_seq_fit_with_prod_sublanes_matches_jax(rng, monkeypatch):
    """The flagship through ``SeqBackend`` (lanes of 512 steps, B7 in 8
    sub-lanes of 64) holds the JAX seq fit within the EM parity bound."""
    monkeypatch.setattr(TFB, "PROD_SUBLANES_FROM", 1)
    monkeypatch.setattr(TFB, "PROD_SUBLANE_T", 64)
    assert TFB.prod_sublanes(512) == 8
    jp = JP.durbin_cpg8()
    chunked = TCH.frame(_stream(rng, 5000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    kw = dict(engine="onehot", lane_T=512, t_tile=128)
    jr = JBW.fit(jp, jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_mesh1(), **kw))
    tr = TBW.fit(_tp(jp), chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.SeqBackend(**kw))
    _fits_agree(jr, tr)
