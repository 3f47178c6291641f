"""The split arm's kernels of the port (B9-B12, B22, B23) vs the JAX package.

On the CPU each kernel wrapper takes its plain PyTorch version; the JAX
package's onehot route runs its XLA twins: ``_xla_fwd_onehot`` (B9),
``_xla_bwd_onehot`` (B10), the off-TPU conf branch of
``run_fb_kernels_onehot(fused=False)`` (B11), the interpret branch of
``run_stats_onehot`` (B12) and the stacked twins ``_xla_fwd_onehot_stacked``
/ ``_xla_bwd_onehot_stacked`` (B22, B23).  Both sides get the same seeded
numpy inputs.  The chains are held within rtol 1e-5, not bit for bit:
XLA:CPU contracts ``a*b + c*d`` into fused multiply-adds, and PyTorch rounds
every product, as the CUDA kernels do (ROADMAP §C).  The confidence is held
within atol 2e-5 and the counts within rtol 1e-5 / atol 1e-3 (B12's twin
sums in another order).  Between the port's own plain versions the
relations are exact: B9's alphas are B4's, and each stacked member's slice
is the single-model plain version's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import prepared as JPR
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_chunked
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH

MASK8 = np.r_[np.ones(4), np.zeros(4)].astype(np.float32)
# (N lanes, T steps, masked PADs inside the chunks): ragged lengths with an
# empty lane and a length-1 lane where N allows, PAD tails, one lane.
_GEOMS = [(6, 3000, True), (1, 8, False), (5, 4099, False)]


def _both(S=4, M=1, seed=0):
    """(JAX params list, port params list): the flagship (S = 4) or
    dinuc_cpg (S = 16) plus M-1 random partition=2 members."""
    first = JP.durbin_cpg8() if S == 4 else JP.dinuc_cpg()
    jps = [first] + [JP.random_hmm(jax.random.PRNGKey(seed + m), 2 * S, S, partition=2)
                     for m in range(1, M)]
    return jps, [params_from_numpy(p.log_pi, p.log_A, p.log_B) for p in jps]


def _batch(rng, N, T, S=4, mask_pads=False):
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    if S == 16:
        chunks = JC.recode_pairs(chunks.ravel()).reshape(N, T)
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    lengths[-1] = max(1, T // 7)
    if N > 3:
        lengths[1], lengths[2] = 0, 1
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    if mask_pads:
        chunks[0, 5:40] = S
        chunks[-1, :3] = S
    return chunks, lengths


def _preps(rng, N, T, S=4, mask_pads=False):
    chunks, lengths = _batch(rng, N, T, S, mask_pads)
    jprep = JPR.prepare_chunked(S, jnp.asarray(chunks), jnp.asarray(lengths), t_tile=512,
                                onehot=True)
    tprep = TPR.prepare_chunked(S, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                t_tile=512)
    return jprep, tprep


def _vec(rng, *shape):
    """Random positive entry vectors, so every lane's chain is exercised."""
    return rng.random(shape).astype(np.float32) + 0.01


def _j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _split_chains(rng, N, T, mask_pads=False):
    """B9 and B10 plain over one prep, with the inputs both sides share."""
    _, (tp,) = _both()
    jprep, tprep = _preps(rng, N, T, mask_pads=mask_pads)
    tab = TFB.prob_tab_ext(tp, TOH._groups(tp))
    a0, b0 = torch.from_numpy(_vec(rng, 2, N)), torch.from_numpy(_vec(rng, 2, N))
    al = TFB.oh_fwd(tprep.pair2, tprep.lens2, a0, tab)
    cs_next = TFB.cs_next_of(al)
    be = TFB.oh_bwd(tprep.pairn2, tprep.lens2, cs_next, b0, tab, T)
    return jprep, tprep, tab, a0, b0, al, cs_next, be


# -- B9, B10: the chains against their XLA twins


@pytest.mark.parametrize("N,T,mask_pads", _GEOMS)
def test_fwd_plain_matches_xla_twin(rng, N, T, mask_pads):
    jprep, tprep, tab, a0, _, al, _, _ = _split_chains(rng, N, T, mask_pads)
    want = jax.jit(JFB._xla_fwd_onehot)(_j(tab), jnp.minimum(jprep.pair2[:, :N], 16),
                                        jprep.lens2[:, :N], _j(a0).T)
    np.testing.assert_allclose(al.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("N,T,mask_pads", _GEOMS)
def test_bwd_plain_matches_xla_twin(rng, N, T, mask_pads):
    """The cs-scaled backward on the same cs_next (c_{t+1} of the port's
    alphas, 1 on the last row)."""
    jprep, tprep, tab, _, b0, _, cs_next, be = _split_chains(rng, N, T, mask_pads)
    want = jax.jit(JFB._xla_bwd_onehot, static_argnums=5)(
        _j(tab), jnp.minimum(jprep.pairn2[:, :N], 16), jprep.lens2[:, :N], _j(cs_next),
        _j(b0).T, T)
    np.testing.assert_allclose(be.numpy(), np.asarray(want), rtol=1e-5)
    assert torch.equal(cs_next[-1], torch.ones(N))


@pytest.mark.parametrize("N,T,mask_pads", _GEOMS)
def test_fwd_plain_equals_fwdbwd_alphas(rng, N, T, mask_pads):
    """B9's alphas are B4's bit for bit (the same forward, op for op)."""
    _, tprep, tab, a0, b0, al, _, _ = _split_chains(rng, N, T, mask_pads)
    al4, _ = TFB.oh_fwdbwd(tprep.pair2, tprep.pairn2, tprep.lens2, a0, b0, tab, T)
    assert torch.equal(al, al4)


# -- B11: the confidence-emitting backward


@pytest.mark.parametrize("N,T,mask_pads", _GEOMS)
def test_bwd_conf_plain_matches_jax_split_runner(rng, N, T, mask_pads):
    """B11 through the port's split runner against the JAX package's
    ``run_fb_kernels_onehot(fused=False, conf_mask=)`` on the same prep and
    entry vectors; and B11's plain version against the confidence of B10's
    plain betas (``conf_from_reduced``) bit for bit."""
    (jp,), (tp,) = _both()
    jprep, tprep = _preps(rng, N, T, mask_pads=mask_pads)
    a0_raw, beta0 = _vec(rng, 8, N), _vec(rng, 8, N)
    jstreams = (jprep.pair2[:, :N], jprep.esym2[:, :N], jprep.pairn2[:, :N])
    _, _, want, _ = jax.jit(
        lambda p, l, a, b, m, s: JFB.run_fb_kernels_onehot(
            p, None, jnp.int32(0), l, a, b, 512, T, conf_mask=m, pair_esym=s, fused=False)
    )(jp, jprep.lens2[:, :N], jnp.asarray(a0_raw), jnp.asarray(beta0), jnp.asarray(MASK8),
      jstreams)
    streams = (tprep.pair2, tprep.esym2, tprep.pairn2)
    args = (tp, None, None, tprep.lens2, torch.from_numpy(a0_raw), torch.from_numpy(beta0), T)
    al, conf, esym2 = TFB.run_fb_kernels_onehot(*args, pair_esym=streams, fused=False,
                                                conf_mask=torch.from_numpy(MASK8))
    np.testing.assert_allclose(conf.numpy(), np.asarray(want), atol=2e-5)
    _, be, _ = TFB.run_fb_kernels_onehot(*args, pair_esym=streams, fused=False)
    gt = TOH._groups(tp)
    assert torch.equal(conf, TFB.conf_from_reduced(al, be, esym2, tprep.lens2,
                                                   torch.from_numpy(MASK8), gt))
    valid = torch.arange(conf.shape[0])[:, None] < tprep.lens2
    assert bool(torch.all(conf[~valid] == 0))


def test_bwd_conf_mask_keys_on_the_position_symbol(rng):
    """B11's mask row is the position's own symbol's: an all-island mask
    gives 1 on every valid step, a one-symbol mask 0 wherever that symbol is
    not emitted."""
    jprep, tprep, tab, a0, b0, al, cs_next, _ = _split_chains(rng, 6, 700, True)
    args = (tprep.pairn2, tprep.pair2, tprep.lens2, cs_next, b0, al)
    valid = torch.arange(tprep.pair2.shape[0])[:, None] < tprep.lens2
    conf = TFB.oh_bwd_conf(*args, torch.ones(4, 2), tab, 700)
    assert torch.allclose(conf, valid.float())
    only_c = torch.zeros(4, 2)
    only_c[1] = 1.0
    conf = TFB.oh_bwd_conf(*args, only_c, tab, 700)
    esym = TFB.decode_esym(tprep.pair2, 4)
    assert bool(torch.all(conf[esym != 1] == 0))
    assert bool(torch.all(conf[(esym == 1) & valid] > 0.999))


# -- B12: the chunked counts over cs-scaled streams


@pytest.mark.parametrize("N,T,mask_pads", [(6, 3000, True), (1, 8, False), (9, 1000, False)])
def test_stats_plain_matches_run_stats_onehot(rng, N, T, mask_pads):
    (jp,), (tp,) = _both()
    jprep, tprep, _, _, _, al, _, be = _split_chains(rng, N, T, mask_pads)
    want = jax.jit(lambda p, a, b, pr, l: JFB.run_stats_onehot(
        p, a, b, pr, l, JOH._groups(p), 512, betas_scale="cs"))(
        jp, _j(al), _j(be), jprep.pair2[:, :N], jprep.lens2[:, :N])
    got = TFB.run_stats_onehot(tp, al, be, tprep.pair2, tprep.lens2, TOH._groups(tp), tprep.Tt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3)


def test_betas_scale_guard():
    """B12 is degree 1 in its betas: only the split arm's cs-scaled betas
    pair with it; fused and one-pass betas raise at the route point."""
    (_, ), (tp,) = _both()
    assert TFB.beta_scale_of(fused=False) == "cs"
    assert TFB.beta_scale_of(fused=True) == "selfnorm"
    assert TFB.beta_scale_of(fused=True, one_pass=True) == "matrix"
    assert TFB.beta_scale_of(fused=False, one_pass=True) == "matrix"
    z = torch.zeros(8, 2, 3)
    for scale in ("selfnorm", "matrix"):
        with pytest.raises(ValueError, match="pairing is a bug"):
            TFB.run_stats_onehot(tp, z, z, torch.zeros(8, 3, dtype=torch.int32),
                                 torch.zeros(1, 3, dtype=torch.int32), TOH._groups(tp), 8,
                                 betas_scale=scale)
    three = params_from_numpy(*(np.asarray(x) for x in (
        lambda p: (p.log_pi, p.log_A, p.log_B))(JP.random_hmm(jax.random.PRNGKey(3), 6, 3,
                                                               partition=2))))
    with pytest.raises(ValueError, match="power-of-two"):
        TFB.run_stats_onehot(three, z, z, torch.zeros(8, 3, dtype=torch.int32),
                             torch.zeros(1, 3, dtype=torch.int32), TOH._groups(three), 8)


# -- B22, B23: the stacked chains


@pytest.mark.parametrize("S,M", [(4, 1), (4, 3), (16, 2)])
def test_stacked_plains_match_xla_twins_and_single(rng, S, M):
    """B22 and B23 against ``_xla_fwd_onehot_stacked`` /
    ``_xla_bwd_onehot_stacked`` within rtol 1e-5; each member's slice equals
    the single-model plain version (B9, B10) bit for bit, and B22's alphas
    equal B24's."""
    _, tps = _both(S, M)
    N, T = 5, 1500
    jprep, tprep = _preps(rng, N, T, S)
    _, tabs = TFB.stacked_tables(tps)
    nreal = S * S
    a0 = torch.from_numpy(_vec(rng, M, 2, N))
    b0 = torch.from_numpy(_vec(rng, M, 2, N))
    al = TFB.oh_fwd_stacked(tprep.pair2, tprep.lens2, a0, tabs)
    cs_next = TFB.cs_next_of(al)
    be = TFB.oh_bwd_stacked(tprep.pairn2, tprep.lens2, cs_next, b0, tabs, T)
    assert al.shape == be.shape == (M, tprep.pair2.shape[0], 2, N)
    jtabs = [_j(tabs[m]) for m in range(M)]
    j_al = jax.jit(JFB._xla_fwd_onehot_stacked)(
        jtabs, jnp.minimum(jprep.pair2[:, :N], nreal), jprep.lens2[:, :N],
        [_j(a0[m]).T for m in range(M)])
    j_be = jax.jit(JFB._xla_bwd_onehot_stacked, static_argnums=5)(
        jtabs, jnp.minimum(jprep.pairn2[:, :N], nreal), jprep.lens2[:, :N],
        [_j(cs_next[m]) for m in range(M)], [_j(b0[m]).T for m in range(M)], T)
    for m in range(M):
        np.testing.assert_allclose(al[m].numpy(), np.asarray(j_al[m]), rtol=1e-5)
        np.testing.assert_allclose(be[m].numpy(), np.asarray(j_be[m]), rtol=1e-5)
        tab = tabs[m].contiguous()
        assert torch.equal(al[m], TFB.oh_fwd(tprep.pair2, tprep.lens2, a0[m], tab))
        assert torch.equal(cs_next[m], TFB.cs_next_of(al[m]))
        assert torch.equal(be[m], TFB.oh_bwd(tprep.pairn2, tprep.lens2, cs_next[m], b0[m],
                                             tab, T))
    al24, _ = TFB.oh_fwdbwd_stacked(tprep.pair2, tprep.pairn2, tprep.lens2, a0, b0, tabs, T)
    assert torch.equal(al, al24)


def test_stacked_split_runner_equals_single_runs(rng):
    """``run_fb_kernels_onehot_stacked(fused=False)`` gives every member
    the single-model split runner's streams and confidence bit for bit."""
    _, tps = _both(4, 3, seed=4)
    N, T = 4, 900
    _, tprep = _preps(rng, N, T)
    streams = (tprep.pair2, tprep.esym2, tprep.pairn2)
    a0s = [torch.from_numpy(_vec(rng, 8, N)) for _ in tps]
    b0s = [torch.ones(8, N)] * 3
    masks = [torch.from_numpy(MASK8)] * 3
    al, be, _ = TFB.run_fb_kernels_onehot_stacked(tps, tprep.lens2, a0s, b0s, T,
                                                  pair_esym=streams, fused=False)
    _, confs, _ = TFB.run_fb_kernels_onehot_stacked(tps, tprep.lens2, a0s, b0s, T,
                                                    pair_esym=streams, fused=False,
                                                    conf_masks=masks)
    for m, p in enumerate(tps):
        args = (p, None, None, tprep.lens2, a0s[m], b0s[m], T)
        a1, b1, _ = TFB.run_fb_kernels_onehot(*args, pair_esym=streams, fused=False)
        _, c1, _ = TFB.run_fb_kernels_onehot(*args, pair_esym=streams, fused=False,
                                             conf_mask=masks[m])
        assert torch.equal(al[m], a1) and torch.equal(be[m], b1)
        assert torch.equal(confs[m], c1)


# -- the wrappers


def test_split_wrappers_refuse_bad_operands(rng):
    _, tprep, tab, a0, b0, al, cs_next, be = _split_chains(rng, 3, 100)
    with pytest.raises(ValueError):
        TFB.oh_fwd(tprep.pair2.long(), tprep.lens2, a0, tab)  # dtype
    with pytest.raises(ValueError):
        TFB.oh_fwd(tprep.pair2, tprep.lens2, a0[:, :2].contiguous(), tab)  # shape
    with pytest.raises(ValueError):
        TFB.oh_fwd(*[x.to("meta") for x in (tprep.pair2, tprep.lens2, a0, tab)])
    with pytest.raises(ValueError):
        TFB.oh_bwd(tprep.pairn2, tprep.lens2, cs_next[:-1].contiguous(), b0, tab, 100)
    with pytest.raises(ValueError):
        TFB.oh_bwd(tprep.pairn2, tprep.lens2, cs_next.T.contiguous().T, b0, tab, 100)
    with pytest.raises(ValueError):  # a mask table of another alphabet
        TFB.oh_bwd_conf(tprep.pairn2, tprep.pair2, tprep.lens2, cs_next, b0, al,
                        torch.ones(3, 2), tab, 100)
    gt = TOH._groups(params_from_numpy(*(np.asarray(x) for x in (
        lambda p: (p.log_pi, p.log_A, p.log_B))(JP.durbin_cpg8())))).to(torch.int32)
    bred = torch.ones(4, 2)
    with pytest.raises(ValueError):
        TFB.oh_stats(al, be, tprep.pair2, tprep.lens2, bred, gt.long(), 512)
    with pytest.raises(ValueError):
        TFB.oh_stats(al, be, tprep.pair2, tprep.lens2, bred, gt, 0)
    _, tabs = TFB.stacked_tables(_both(4, 2)[1])
    with pytest.raises(ValueError):
        TFB.oh_fwd_stacked(tprep.pair2, tprep.lens2, a0, tabs)  # [2, NL], not [M, 2, NL]
    with pytest.raises(ValueError):
        TFB.oh_bwd_stacked(tprep.pairn2, tprep.lens2, cs_next, torch.stack([b0, b0]), tabs, 100)


def test_split_batch_stats_prepared_equals_inline(rng):
    """The split chunked E-step through a held prep equals the inline one,
    and its statistics stay within the pass-fusion bounds of the fused
    arm's (tests/test_passfusion.py)."""
    _, (tp,) = _both()
    chunks, lengths = _batch(rng, 5, 900, mask_pads=True)
    c, n = torch.from_numpy(chunks), torch.from_numpy(lengths)
    prep = TPR.prepare_chunked(4, c, n, t_tile=fb_chunked.DEFAULT_T_TILE)
    inline = fb_chunked.batch_stats(tp, c, n, fused=False)
    held = fb_chunked.batch_stats(tp, c, n, prepared=prep, fused=False)
    fused = fb_chunked.batch_stats(tp, c, n, prepared=prep)
    for f in ("init", "trans", "emit", "loglik", "n_seqs"):
        assert torch.equal(getattr(inline, f), getattr(held, f)), f
    np.testing.assert_allclose(held.init.numpy(), fused.init.numpy(), atol=1e-5)
    for f in ("trans", "emit"):
        np.testing.assert_allclose(getattr(held, f).numpy(), getattr(fused, f).numpy(),
                                   rtol=5e-5, atol=1e-3)
    assert float(held.loglik) == pytest.approx(float(fused.loglik), rel=1e-5)
