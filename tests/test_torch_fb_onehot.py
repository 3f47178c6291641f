"""The reduced chunked E-step of the PyTorch port vs the JAX package.

On the CPU the port's kernel wrappers (B4 ``oh_fwdbwd``, B5
``oh_seq_stats``) take their plain PyTorch versions, and the JAX package's
onehot route runs its XLA twins (``_xla_fwdbwd_onehot``,
``_xla_znorm_stats``).  The symbol-only prep is integer work and is held
exactly.  The float work is held within rtol 1e-5, not bit for bit:
XLA:CPU contracts ``a*b + c*d`` into fused multiply-adds (about one result
in six of such an expression differs in the last bit from unfused float32
arithmetic), and PyTorch rounds every product, as the CUDA kernel does.
The difference stays at a few ulps along the 2-state chains, because each
step renormalizes.  The chunk statistics are held to the tolerances of the
JAX package's own onehot-vs-dense parity test (tests/test_fb_onehot.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu.ops import prepared as JPR
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_chunked
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH


def _both():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _batch(rng, N, T, mask_pads=False):
    """Seeded [N, T] chunks with ragged lengths (a full lane, a short last
    lane, a one-symbol lane, an empty lane), PAD tails and, optionally,
    masked PADs inside the chunks."""
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    lengths[-1] = max(1, T // 7)
    if N > 3:
        lengths[1], lengths[2] = 0, 1
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    if mask_pads:
        chunks[0, 5:40] = 4
        chunks[-1, :3] = 4
    return chunks, lengths


def _prep_both(rng, N, T, mask_pads=False):
    chunks, lengths = _batch(rng, N, T, mask_pads)
    jprep = JPR.prepare_chunked(4, jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True)
    tprep = TPR.prepare_chunked(4, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                t_tile=512)
    return chunks, lengths, jprep, tprep


@pytest.mark.parametrize("N,T,mask_pads", [(6, 3000, True), (1, 8, False), (3, 4099, False)])
def test_prepare_chunked_matches_jax(rng, N, T, mask_pads):
    """The port lays lanes out unpadded (NL = N) on the JAX package's
    [Tp, .] step geometry; every stream equals the JAX one on its N lanes."""
    _, _, jp, tp = _prep_both(rng, N, T, mask_pads)
    assert (tp.S, tp.Tt, tp.N, tp.T) == (jp.S, jp.Tt, jp.N, jp.T)
    for name in ("steps2", "lens2", "sel2", "pair2", "esym2", "pairn2"):
        j, t = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert t.shape == (j.shape[0], N) and np.array_equal(j[:, :N], t), name


def test_pair_table_and_esym_match_jax():
    jp, tp = _both()
    jgt, tgt = JOH._groups(jp), TOH._groups(tp)
    assert np.array_equal(np.asarray(jgt), tgt.numpy())
    # XLA:CPU's float32 exp is not correctly rounded (PyTorch's is): the
    # tables differ by at most an ulp.
    np.testing.assert_allclose(TFB.prob_pair_table(tp, tgt).numpy(),
                               np.asarray(JFB.prob_pair_table(jp, jgt)), rtol=3e-7)
    pairs = np.arange(24, dtype=np.int32).reshape(4, 6)
    assert np.array_equal(TFB.decode_esym(torch.from_numpy(pairs), 4).numpy(),
                          np.asarray(JFB.decode_esym(jnp.asarray(pairs), 4)))


def _fb_inputs(rng, N, T, mask_pads=False):
    """Both packages' fwd/bwd inputs from the same prep, tables and entry
    vectors (random positive ones, so every lane's chain is exercised)."""
    _, tp = _both()
    _, _, jprep, tprep = _prep_both(rng, N, T, mask_pads)
    tab = TFB.prob_tab_ext(tp, TOH._groups(tp))
    a0 = rng.random((2, N)).astype(np.float32) + 0.01
    b0 = rng.random((2, N)).astype(np.float32) + 0.01
    return jprep, tprep, tab, a0, b0


@pytest.mark.parametrize("N,T,mask_pads", [(6, 3000, True), (1, 8, False), (3, 4099, False)])
def test_fwdbwd_plain_matches_xla_twin(rng, N, T, mask_pads):
    jprep, tprep, tab, a0, b0 = _fb_inputs(rng, N, T, mask_pads)
    j_al, j_be = jax.jit(JFB._xla_fwdbwd_onehot, static_argnums=6)(
        jnp.asarray(tab.numpy()), jnp.minimum(jprep.pair2[:, :N], 16),
        jnp.minimum(jprep.pairn2[:, :N], 16), jprep.lens2[:, :N], jnp.asarray(a0.T),
        jnp.asarray(b0.T), T)
    t_al, t_be = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2,
                               torch.from_numpy(a0), torch.from_numpy(b0), tab, T)
    np.testing.assert_allclose(t_al.numpy(), np.asarray(j_al), rtol=1e-5)
    np.testing.assert_allclose(t_be.numpy(), np.asarray(j_be), rtol=1e-5)


@pytest.mark.parametrize("enters", [False, True])
def test_seq_stats_plain_matches_xla_twin(rng, enters):
    """z-normalized counts on the same streams: the chunked caller's zero
    enters and pair0 mask, and random ones (the within-lane t == 0 pair)."""
    jp, tp = _both()
    N, T = 5, 2000
    jprep, tprep, tab, a0, b0 = _fb_inputs(rng, N, T, mask_pads=True)
    al, be = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2, torch.from_numpy(a0),
                           torch.from_numpy(b0), tab, T)
    K = 8
    ef = rng.random((K, N)).astype(np.float32) if enters else np.zeros((K, N), np.float32)
    er = rng.random((2, N)).astype(np.float32) if enters else np.zeros((2, N), np.float32)
    m0 = (rng.random((1, N)) < 0.6).astype(np.float32) if enters else np.zeros((1, N), np.float32)
    jgt = JOH._groups(jp)
    want = jax.jit(JFB._xla_znorm_stats)(
        jp, jnp.asarray(al.numpy()), jnp.asarray(be.numpy()), jprep.pair2[:, :N],
        jprep.lens2[:, :N], jgt, jnp.asarray(er), jnp.asarray(ef), jnp.asarray(m0))
    got = TFB.run_seq_stats_onehot(tp, al, be, tprep.pair2, tprep.lens2, TOH._groups(tp),
                                   torch.from_numpy(er), torch.from_numpy(ef),
                                   torch.from_numpy(m0), tprep.Tt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,T,mask_pads", [(6, 3000, True), (9, 1000, False)])
def test_batch_stats_matches_jax(rng, N, T, mask_pads):
    """The port's chunked E-step vs ``batch_stats_pallas(onehot=True,
    fused=True)`` at ragged chunks."""
    jp, tp = _both()
    chunks, lengths = _batch(rng, N, T, mask_pads)
    sj = JFP.batch_stats_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True, fused=True)
    st = fb_chunked.batch_stats(tp, torch.from_numpy(chunks), torch.from_numpy(lengths))
    np.testing.assert_allclose(st.init.numpy(), np.asarray(sj.init), atol=1e-5)
    np.testing.assert_allclose(st.trans.numpy(), np.asarray(sj.trans), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(st.emit.numpy(), np.asarray(sj.emit), rtol=1e-5, atol=1e-3)
    assert float(st.loglik) == pytest.approx(float(sj.loglik), rel=1e-6)
    assert int(st.n_seqs) == int(sj.n_seqs)
    # The one-hot emission zeros stay exact zeros.
    assert np.array_equal(st.emit.numpy() == 0, np.asarray(sj.emit) == 0)


def test_batch_stats_prepared_equals_inline(rng):
    _, tp = _both()
    chunks, lengths = _batch(rng, 4, 700)
    c, n = torch.from_numpy(chunks), torch.from_numpy(lengths)
    inline = fb_chunked.batch_stats(tp, c, n)
    prep = TPR.prepare_chunked(4, c, n, t_tile=fb_chunked.DEFAULT_T_TILE)
    held = fb_chunked.batch_stats(tp, c, n, prepared=prep)
    for f in ("init", "trans", "emit", "loglik", "n_seqs"):
        assert torch.equal(getattr(inline, f), getattr(held, f)), f
    with pytest.raises(ValueError, match="prepared streams"):
        fb_chunked.batch_stats(tp, c[:3], n[:3], prepared=prep)


def test_wrappers_refuse_bad_operands(rng):
    _, tp = _both()
    _, tprep, tab, a0, b0 = _fb_inputs(rng, 3, 100)
    a0, b0 = torch.from_numpy(a0), torch.from_numpy(b0)
    args = [tprep.pair2, tprep.pairn2, tprep.lens2, a0, b0, tab, 100]
    with pytest.raises(ValueError):
        TFB.oh_fwdbwd(tprep.pair2.long(), *args[1:])  # dtype
    with pytest.raises(ValueError):
        TFB.oh_fwdbwd(*args[:3], a0[:, :2].contiguous(), *args[4:])  # shape
    with pytest.raises(ValueError):
        TFB.oh_fwdbwd(tprep.pair2.T.contiguous().T, *args[1:])  # not contiguous
    with pytest.raises(ValueError):
        TFB.oh_fwdbwd(*[x.to("meta") if isinstance(x, torch.Tensor) else x for x in args])
    al, be = TFB.oh_fwdbwd(*args)
    gt = TOH._groups(tp).to(torch.int32)
    z = torch.zeros
    with pytest.raises(ValueError, match="K == 2S"):
        TFB.oh_seq_stats(al, be, tprep.pair2, tprep.lens2, tab, z(4, 2), gt, z(6, 3),
                         z(2, 3), z(1, 3), 512)
    with pytest.raises(ValueError):
        TFB.oh_seq_stats(al, be, tprep.pair2, tprep.lens2, tab, z(4, 2), gt, z(8, 3),
                         z(2, 3), z(1, 3), 0)
    # The split arm runs: its forward (B9) is B4's, bit for bit.
    al_s, _, _ = TFB.run_fb_kernels_onehot(tp, tprep.sel2, 0, tprep.lens2, a0.repeat(4, 1),
                                           torch.ones(8, 3), 100, fused=False)
    al_f, _, _ = TFB.run_fb_kernels_onehot(tp, tprep.sel2, 0, tprep.lens2, a0.repeat(4, 1),
                                           torch.ones(8, 3), 100)
    assert torch.equal(al_s, al_f)
    # The fused arm's confidence comes from B4's streams, the split arm's
    # from B11.
    valid = torch.arange(al_f.shape[0])[:, None] < tprep.lens2
    for fused in (True, False):
        _, conf, _ = TFB.run_fb_kernels_onehot(tp, tprep.sel2, 0, tprep.lens2,
                                               a0.repeat(4, 1), torch.ones(8, 3), 100,
                                               conf_mask=torch.ones(8), fused=fused)
        assert torch.allclose(conf, valid.float())  # every state counted: 1 on valid steps


def test_run_fb_kernels_inline_pairs_equal_prepared(rng):
    """Without a prepared pair stream the runner builds it from the
    selection symbols: the same streams, the same chains."""
    _, tp = _both()
    _, tprep, _, _, _ = _fb_inputs(rng, 4, 500, mask_pads=True)
    a0 = torch.from_numpy(rng.random((8, 4)).astype(np.float32))
    b0 = torch.ones(8, 4)
    prepared = TFB.run_fb_kernels_onehot(
        tp, None, None, tprep.lens2, a0, b0, 500,
        pair_esym=(tprep.pair2, tprep.esym2, tprep.pairn2))
    inline = TFB.run_fb_kernels_onehot(tp, tprep.sel2, 0, tprep.lens2, a0, b0, 500)
    for x, y in zip(prepared, inline):
        assert torch.equal(x, y)
