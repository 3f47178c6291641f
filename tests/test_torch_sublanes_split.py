"""B9 / B22 and B10 / B23 in sub-lanes: the split arm's chains vs the JAX package.

B9 (the forward alone) runs each lane of Tp steps as B4's G =
``fb_onehot.sublanes(Tp)`` sub-lanes with B4's operations, so its alphas
equal B4's bit for bit.  B10 (the backward with true Rabiner betas, each
step's contraction times 1 / c_{t+1}) is degree 1 in beta, so it runs as G
= ``fb_onehot.split_bwd_sublanes(Tp)`` sub-lanes joined by messages that
carry the betas' magnitude: each sub-lane's transfer matrix scaled by
powers of two (exact) with the exponents summed in an int, B18's design.
In float32 both differ from the sequential chains in the last bits, so the
G > 1 plain versions are held against the JAX package's sequential twins
``_xla_fwd_onehot`` / ``_xla_bwd_onehot`` (and their stacked forms) within
rtol 1e-5 / atol 1e-6, the bound that already covers XLA:CPU's FMA
contraction (tests/test_torch_fb_split.py), on ragged lanes with PAD runs
across sub-lane boundaries, lengths that end before a sub-lane starts, and
a lane whose unscaled sub-lane product leaves float32's range.  The
sub-lane lengths are set small here so that a few thousand steps make
several sub-lanes.  With G = 1 each is its sequential plain version bit
for bit; stacked members equal their own single-model runs.  End to end,
with the lengths lowered: B12's counts over the G > 1 streams, a flagship
``LocalBackend(fuse_fb=False)`` and ``SeqBackend(fuse_fb=False)`` fit, and
the island file of ``posterior_sharded(fused=False, want_path=True)`` hold
the JAX package's split arm (the EM parity bound; the island file byte for
byte).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu.ops import islands as JIS
from cpgisland_tpu.parallel import posterior as JPO
from cpgisland_tpu.train import backends as JBE
from cpgisland_tpu.train import baum_welch as JBW
from cpgisland_tpu.utils import chunking as JCH
from cpgisland_tpu_torch.ops import fb_chunked
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import fb_pallas as TFP
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import islands as TIS
from cpgisland_tpu_torch.parallel import posterior as TPO
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH

from test_torch_cuda import _drift_streams
from test_torch_fb_split import _both, _j, _preps, _vec
from test_torch_split_paths import ITERS, _fits_agree, _genome, _mesh1, _stats_close

RTOL, ATOL = 1e-5, 1e-6
NREAL = 16  # the flagship's S * S: PAD pairs clamp onto the identity row

# (lanes, chunk length, B9's sub-lane length, B10's): Tp is the chunk length
# rounded up to 512 — B9 in 12 sub-lanes of 256, 6 of 342 and 10 of 103; B10
# in 10 of 308, 7 of 293 and 10 of 103, the last ones shorter.
GEOMS = [(10, 3000, 256, 300), (8, 2000, 300, 290), (5, 1000, 100, 100)]


def _lengths(sub_f, sub_b):
    """The first lanes' lengths: a full lane, an empty one, one symbol, a
    B9 and a B10 sub-lane boundary and a step past each, and a length that
    ends before the second sub-lane starts."""
    return [None, 0, 1, sub_f, sub_f + 1, sub_b, sub_b + 1, sub_b // 2]


def _sub(monkeypatch, sub_f=None, sub_b=None):
    """B9 in sub-lanes of ``sub_f`` steps, B10 in sub-lanes of ``sub_b`` at
    every lane length."""
    if sub_f is not None:
        monkeypatch.setattr(TFB, "SUBLANE_T", sub_f)
    if sub_b is not None:
        monkeypatch.setattr(TFP, "BWD_SUBLANE_T", sub_b)
        monkeypatch.setattr(TFP, "BWD_SUBLANES_FROM", 1)


def _chains(rng, N, T, sub_f, sub_b, M=1):
    """The preps of a ragged batch (PAD runs inside the chunks, lengths on
    the sub-lane boundaries) and M members' pair tables and vectors."""
    _, tps = _both(4, M, seed=N)
    jprep, tprep = _preps(rng, N, T, mask_pads=True)
    lens = tprep.lens2.clone()
    for n, ln in enumerate(_lengths(sub_f, sub_b)[:N]):
        if ln is not None:
            lens[0, n] = ln
    tabs = torch.stack([TFB.prob_tab_ext(p, TFB._groups(p)) for p in tps])
    a0 = torch.from_numpy(_vec(rng, M, 2, N))
    b0 = torch.from_numpy(_vec(rng, M, 2, N))
    return jprep, tprep, lens, tabs, a0, b0


def _jax_fwd(tab, jprep, lens, a0):
    N = lens.shape[1]
    return np.asarray(jax.jit(JFB._xla_fwd_onehot)(
        _j(tab), jnp.minimum(jprep.pair2[:, :N], NREAL), _j(lens), _j(a0).T))


def _jax_bwd(tab, pairn, lens, cs_next, b0, T):
    return np.asarray(jax.jit(JFB._xla_bwd_onehot, static_argnums=5)(
        _j(tab), jnp.minimum(_j(pairn), NREAL), _j(lens), _j(cs_next), _j(b0).T, T))


# -- B9 ------------------------------------------------------------------------------


@pytest.mark.parametrize("N,T,sub_f,sub_b", GEOMS)
def test_fwd_sublanes_plain_matches_xla_twin(rng, monkeypatch, N, T, sub_f, sub_b):
    """B9 at G > 1 vs ``_xla_fwd_onehot``, equal to B4's alphas bit for bit,
    and past each lane's last valid step every alpha is that step's."""
    jprep, tprep, lens, tabs, a0, b0 = _chains(rng, N, T, sub_f, sub_b)
    tab = tabs[0]
    _sub(monkeypatch, sub_f=sub_f)
    assert TFB.sublanes(tprep.pair2.shape[0]) > 1
    al = TFB.oh_fwd(tprep.pair2, lens, a0[0], tab)
    np.testing.assert_allclose(al.numpy(), _jax_fwd(tab, jprep, lens, a0[0]), rtol=RTOL,
                               atol=ATOL)
    al4, _ = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, lens, a0[0], b0[0], tab, T)
    assert torch.equal(al, al4)
    for n, ln in enumerate(lens[0].tolist()):
        last = max(ln, 1) - 1
        assert torch.equal(al[last:, :, n], al[last, :, n].expand_as(al[last:, :, n]))


# -- B10 -----------------------------------------------------------------------------


@pytest.mark.parametrize("N,T,sub_f,sub_b", GEOMS)
def test_bwd_sublanes_plain_matches_xla_twin(rng, monkeypatch, N, T, sub_f, sub_b):
    """B10 at G > 1 vs ``_xla_bwd_onehot`` on the same cs_next (c_{t+1} of
    B9's alphas); where no step is valid (t >= min(T - 1, len - 1)) beta0
    is carried exactly: the last valid sub-lane starts from beta0 itself."""
    jprep, tprep, lens, tabs, a0, b0 = _chains(rng, N, T, sub_f, sub_b)
    tab = tabs[0]
    _sub(monkeypatch, sub_b=sub_b)
    assert TFB.split_bwd_sublanes(tprep.pairn2.shape[0]) > 1
    cs_next = TFB.cs_next_of(TFB.oh_fwd(tprep.pair2, lens, a0[0], tab))
    be = TFB.oh_bwd(tprep.pairn2, lens, cs_next, b0[0], tab, T)
    want = _jax_bwd(tab, jprep.pairn2[:, :N], lens, cs_next, b0[0], T)
    np.testing.assert_allclose(be.numpy(), want, rtol=RTOL, atol=ATOL)
    for n, ln in enumerate(lens[0].tolist()):
        lim = max(min(T - 1, ln - 1), 0)
        assert torch.equal(be[lim:, :, n], b0[0, :, n].expand_as(be[lim:, :, n]))


def test_bwd_power_of_two_scaling_keeps_range(rng, monkeypatch):
    """Three sub-lanes of 1,024 steps whose betas fall by 2^100, rise by
    2^200 and fall by 2^100 walking down: the middle sub-lane's unscaled
    transfer matrix overflows float32, yet the scaled messages carry the
    true magnitudes — every beta finite and within the twin's bound, the
    betas spanning 2^-90 to 2^90."""
    Tp, NL, sub = 3072, 6, 1024
    tab, pairn, cs, b0, G64 = _drift_streams(rng, Tp, NL, sub, (-100, 200, -100))
    lens = np.full((1, NL), Tp, np.int32)
    lens[0, 4] = 3000  # a length ending inside the last sub-lane
    _sub(monkeypatch, sub_b=sub)
    assert TFB.split_bwd_sublanes(Tp) == 3
    Q = np.eye(2)  # the middle sub-lane's product, unscaled, in float64
    for t in range(2 * sub - 1, sub - 1, -1):
        Q = (G64[t, 0] / cs[t, 0]) @ Q
    assert np.log2(np.abs(Q).max()) > 140
    got = TFB.oh_bwd(torch.from_numpy(pairn), torch.from_numpy(lens), torch.from_numpy(cs),
                     torch.from_numpy(b0), tab, Tp).numpy()
    want = _jax_bwd(tab, pairn, lens, cs, b0, Tp)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert got.max() > 2.0**90 and got[got > 0].min() < 2.0**-90
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# -- G = 1 ---------------------------------------------------------------------------


@pytest.mark.parametrize("Tp,sub", [(4096, None), (4608, None), (8191, None), (3000, 3000)])
def test_one_sublane_is_the_sequential_plain(rng, monkeypatch, Tp, sub):
    """G = 1 is the sequential chain bit for bit, B9's (B4's one-chain
    forward) and B10's (the twin's op for op): lanes below 8 Ki steps at
    the module's constants (the CPU tests' lanes), or sub-lanes as long as
    the lane."""
    if sub is not None:
        _sub(monkeypatch, sub_f=sub, sub_b=sub)
    assert TFB.sublanes(Tp) == TFB.split_bwd_sublanes(Tp) == 1
    tab, pairn, cs, b0, _ = _drift_streams(rng, Tp, 4, Tp, (0,))
    pair = torch.from_numpy(np.roll(pairn, 1, axis=0))
    lens = torch.from_numpy(np.array([[Tp, 1, 17, Tp // 3]], np.int32))
    a0 = torch.from_numpy(_vec(rng, 2, 4))
    seq_f = TFB.fwd_chain_plain(TFB._step_matrices(tab, pair, [0, 1, 2, 3]), lens, a0)
    assert torch.equal(TFB.oh_fwd(pair, lens, a0, tab), seq_f)
    args = (torch.from_numpy(pairn), lens, torch.from_numpy(cs), torch.from_numpy(b0), tab)
    seq_b = TFB._bwd_plain(args[0], lens, args[3], tab, Tp - 5, cs_next=args[2])
    assert torch.equal(TFB.oh_bwd(*args, Tp - 5), seq_b)


def test_bwd_conf_takes_b10_sublanes(rng, monkeypatch):
    """B11 runs B10's chain in B10's sub-lanes: its plain version is the
    confidence epilogue over B10's G > 1 betas bit for bit (what the
    stacked split posterior computes from B23's), within atol 1e-6 of the
    epilogue over the sequential betas."""
    _sub(monkeypatch, sub_b=100)
    jprep, tprep, lens, tabs, a0, b0 = _chains(rng, 5, 1000, 256, 100)
    tab = tabs[0]
    al = TFB.oh_fwd(tprep.pair2, lens, a0[0], tab)
    cs_next = TFB.cs_next_of(al)
    mtab = torch.from_numpy(np.r_[np.ones(4), np.zeros(4)].astype(np.float32))[
        TFB._groups(_both()[1][0])].contiguous()
    conf = TFB.oh_bwd_conf(tprep.pairn2, tprep.pair2, lens, cs_next, b0[0], al, mtab, tab, 1000)
    esym = TFB.decode_esym(tprep.pair2, 4)
    be = TFB.oh_bwd(tprep.pairn2, lens, cs_next, b0[0], tab, 1000)
    assert TFB.split_bwd_sublanes(tprep.pairn2.shape[0]) > 1
    assert torch.equal(conf, TFB._conf_from_mtab(al, be, esym, lens, mtab))
    seq = TFB._bwd_plain(tprep.pairn2, lens, b0[0], tab, 1000, cs_next=cs_next)
    torch.testing.assert_close(conf, TFB._conf_from_mtab(al, seq, esym, lens, mtab),
                               rtol=0, atol=1e-6)


# -- the stacked forms ---------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 3])
def test_stacked_sublanes_match_twins_and_single_runs(rng, monkeypatch, M):
    """B22 and B23 at G > 1 vs ``_xla_fwd_onehot_stacked`` /
    ``_xla_bwd_onehot_stacked``, every member equal to its own B9 / B10 bit
    for bit and B22's alphas to B24's."""
    N, T, sub_f, sub_b = GEOMS[0]
    jprep, tprep, lens, tabs, a0, b0 = _chains(rng, N, T, sub_f, sub_b, M)
    _sub(monkeypatch, sub_f, sub_b)
    al = TFB.oh_fwd_stacked(tprep.pair2, lens, a0, tabs)
    cs_next = TFB.cs_next_of(al)
    be = TFB.oh_bwd_stacked(tprep.pairn2, lens, cs_next, b0, tabs, T)
    jtabs = [_j(tabs[m]) for m in range(M)]
    j_al = jax.jit(JFB._xla_fwd_onehot_stacked)(
        jtabs, jnp.minimum(jprep.pair2[:, :N], NREAL), _j(lens), [_j(a0[m]).T for m in range(M)])
    j_be = jax.jit(JFB._xla_bwd_onehot_stacked, static_argnums=5)(
        jtabs, jnp.minimum(jprep.pairn2[:, :N], NREAL), _j(lens),
        [_j(cs_next[m]) for m in range(M)], [_j(b0[m]).T for m in range(M)], T)
    for m in range(M):
        np.testing.assert_allclose(al[m].numpy(), np.asarray(j_al[m]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(be[m].numpy(), np.asarray(j_be[m]), rtol=RTOL, atol=ATOL)
        tab = tabs[m].contiguous()
        assert torch.equal(al[m], TFB.oh_fwd(tprep.pair2, lens, a0[m], tab))
        assert torch.equal(be[m], TFB.oh_bwd(tprep.pairn2, lens, cs_next[m], b0[m], tab, T))
    al24, _ = TFB.oh_fwdbwd_stacked(tprep.pair2, tprep.pairn2, lens, a0, b0, tabs, T)
    assert torch.equal(al, al24)


# -- the G rules ---------------------------------------------------------------------


@pytest.mark.parametrize("Tp,sub,start,G", [
    (4096, 1024, 8192, 1), (8191, 1024, 8192, 1), (8192, 1024, 8192, 8),
    (65536, 1024, 8192, 32), (65536, 4096, 8192, 16), (16384, 512, 8192, 32),
    (3072, 300, 1, 10), (1024, 100, 1, 10), (8, 1024, 1, 1)])
def test_split_bwd_sublane_count(monkeypatch, Tp, sub, start, G):
    monkeypatch.setattr(TFP, "BWD_SUBLANE_T", sub)
    monkeypatch.setattr(TFP, "BWD_SUBLANES_FROM", start)
    assert TFB.split_bwd_sublanes(Tp) == G == TFP.bwd_sublanes(Tp, 2)


def test_split_sublane_defaults():
    """The module's rules: B10 in B18's sub-lanes of 1 Ki steps, 32 on the
    training batch's 64 Ki-step lanes and 8 on the posterior and ``seq``
    lanes of 8 Ki steps, one chain below 8 Ki steps; B9 in B4's sub-lanes,
    16 and 2 there."""
    assert (TFP.BWD_SUBLANE_T, TFP.BWD_SUBLANES_FROM) == (1024, 8192)
    assert TFB.split_bwd_sublanes(TCH.TRAIN_CHUNK) == 32
    assert TFB.split_bwd_sublanes(fb_seq.DEFAULT_LANE_T) == 8
    assert TFB.split_bwd_sublanes(fb_seq.DEFAULT_LANE_T - 1) == 1
    assert TFB.sublanes(TCH.TRAIN_CHUNK) == 16 and TFB.sublanes(fb_seq.DEFAULT_LANE_T) == 2


# -- end to end ----------------------------------------------------------------------


def test_batch_stats_over_sublane_streams_match_jax(rng, monkeypatch):
    """B12's counts over the G > 1 streams (``batch_stats(fused=False)``:
    B9 in 12 sub-lanes, B10 in 10) vs ``batch_stats_pallas(onehot=True,
    fused=False)``: within rtol 1e-5 / atol 1e-3."""
    jps, tps = _both()
    N, T = 6, 3000
    chunks = np.stack([_genome(rng, T) for _ in range(N)])
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[:3] = T, 0, 256
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    _sub(monkeypatch, 256, 300)
    assert TFB.sublanes(3072) == 12 and TFB.split_bwd_sublanes(3072) == 10
    sj = JFP.batch_stats_pallas(jps[0], jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True, fused=False)
    st = fb_chunked.batch_stats(tps[0], torch.from_numpy(chunks), torch.from_numpy(lengths),
                                fused=False)
    _stats_close(st, sj, rtol=1e-5, atol=1e-3)


def test_local_split_fit_with_sublanes_matches_jax(rng, monkeypatch):
    """A 3-iteration flagship fit through ``LocalBackend(fuse_fb=False)`` on
    2 Ki chunks, B9 in 8 sub-lanes of 256 and B10 in 6 of 342, holds the
    JAX split fit within the EM parity bound."""
    _sub(monkeypatch, 256, 300)
    assert TFB.sublanes(2048) == 8 and TFB.split_bwd_sublanes(2048) == 6
    jps, tps = _both()
    chunked = TCH.frame(_genome(rng, 9000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    jr = JBW.fit(jps[0], jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.LocalBackend(engine="onehot", fuse_fb=False))
    tr = TBW.fit(tps[0], chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.LocalBackend(engine="onehot", fuse_fb=False))
    _fits_agree(jr, tr)


def test_seq_split_fit_with_sublanes_matches_jax(rng, monkeypatch):
    """A 3-iteration flagship fit through ``SeqBackend(fuse_fb=False)``
    (lanes of 512 steps: B9 in 4 sub-lanes of 128, B10 in 5 of 103) holds
    the JAX seq fit on a one-device mesh within the EM parity bound."""
    _sub(monkeypatch, 128, 100)
    assert TFB.sublanes(512) == 4 and TFB.split_bwd_sublanes(512) == 5
    jps, tps = _both()
    chunked = TCH.frame(_genome(rng, 5000), 2048)
    jchunked = JCH.Chunked(chunks=chunked.chunks, lengths=chunked.lengths, total=chunked.total)
    kw = dict(engine="onehot", lane_T=512, t_tile=128, fuse_fb=False)
    jr = JBW.fit(jps[0], jchunked, num_iters=ITERS, convergence=0.0,
                 backend=JBE.SeqBackend(mesh=_mesh1(), **kw))
    tr = TBW.fit(tps[0], chunked, num_iters=ITERS, convergence=0.0,
                 backend=TBE.SeqBackend(**kw))
    _fits_agree(jr, tr)


def test_split_posterior_island_file_with_sublanes_matches_jax(rng, monkeypatch):
    """``posterior_sharded(fused=False, want_path=True)`` over 1 Ki-step
    lanes, B9 in 4 sub-lanes of 256 and B10 in 4 of 256: the island calls
    of its MPM path, written as the island file, equal the JAX package's
    byte for byte, the confidence within atol 2e-5."""
    _sub(monkeypatch, 256, 256)
    assert TFB.sublanes(1024) == 4 and TFB.split_bwd_sublanes(1024) == 4
    jps, tps = _both()
    obs = _genome(rng, 12000)
    isl = (0, 1, 2, 3)
    c_j, p_j = JPO.posterior_sharded(jps[0], obs, isl, mesh=_mesh1(), engine="onehot",
                                     lane_T=1024, want_path=True, fused=False)
    c_t, p_t = TPO.posterior_sharded(tps[0], obs, isl, engine="onehot", lane_T=1024,
                                     want_path=True, fused=False)
    np.testing.assert_allclose(c_t, np.asarray(c_j)[: obs.size], rtol=0, atol=2e-5)
    want = JIS.call_islands(np.asarray(p_j)[: obs.size], chunk=0, compat=False).format_lines()
    got = TIS.call_islands(np.asarray(p_t), chunk=0, compat=False).format_lines()
    assert got == want and want.count("\n") >= 2


@pytest.mark.parametrize("want_path", [False, True])
def test_stacked_split_posterior_with_sublanes(rng, monkeypatch, want_path):
    """``posterior_sharded_stacked(fused=False)`` over 1 Ki-step lanes, B22
    and B23 in 4 sub-lanes of 256: every member's confidence (and path)
    equals its own ``posterior_sharded(fused=False)`` runs bit for bit,
    with the path (B9 and B10, the chains B22 and B23 run per member) and
    without it (B9 and B11, B10's chain in B10's sub-lanes)."""
    _sub(monkeypatch, 256, 256)
    _, tps = _both(4, 2, seed=3)
    obs = _genome(rng, 6000)
    states = [(0, 1, 2, 3), (0, 3, 6)]
    conf, path = TPO.posterior_sharded_stacked(tps, obs, states, want_path=want_path,
                                               lane_T=1024, fused=False)
    for m, p in enumerate(tps):
        kw = dict(engine="onehot", lane_T=1024, fused=False)
        c1, p1 = TPO.posterior_sharded(p, obs, states[m], want_path=True, **kw)
        assert np.array_equal(conf[m], c1)
        assert not want_path or np.array_equal(path[m], p1)
        c11, _ = TPO.posterior_sharded(p, obs, states[m], **kw)
        assert np.array_equal(conf[m], c11)
