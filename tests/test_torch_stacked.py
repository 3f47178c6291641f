"""The stacked kernels of the port (B21, B24, B25 and the stacked scoring
launch) vs the single-model kernels and vs the JAX package; their
modules are held in tests/test_torch_stacked_paths.py.

On the CPU every stacked wrapper takes its plain version, which carries the
member axis through one step loop.  Per member it does the single-model
plain version's operations, so it equals that version bit for bit, and
``sequence_loglik_stacked`` equals M single-model scores bit for bit.
Against the JAX package's XLA twins (``_xla_products_prob_stacked``,
``_xla_fwdbwd_onehot_stacked``, ``_xla_znorm_stats``) they agree within
the single-model tolerances (rtol 1e-5): XLA:CPU contracts products into
FMAs.

Member sets: the flagship plus random ``partition=2`` members at K = 8 /
S = 4, and dinuc_cpg plus a random pair member at K = 32 / S = 16, drawn
by the JAX package and carried across as arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops import loglik as TL
from cpgisland_tpu_torch.ops.prepared import prepare_chunked

# (alphabet, members): the flagship family at S = 4, the pair family at S = 16.
_SETS = [(4, 1), (4, 2), (4, 3), (16, 1), (16, 2)]


def _members(S, M, seed=0):
    """(JAX params list, port params list) of M members of one alphabet."""
    first = JP.durbin_cpg8() if S == 4 else JP.dinuc_cpg()
    jps = [first] + [JP.random_hmm(jax.random.PRNGKey(seed + m), 2 * S, S, partition=2)
                     for m in range(1, M)]
    return jps, [params_from_numpy(p.log_pi, p.log_A, p.log_B) for p in jps]


def _chunks(rng, S, N, T):
    """Seeded [N, T] chunks of the alphabet (pair-recoded, so consecutive
    pairs chain, at S = 16): ragged lengths, an empty lane, PAD tails."""
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    if S == 16:
        chunks = JC.recode_pairs(chunks.ravel()).reshape(N, T)
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    if N > 2:
        lengths[1] = 0
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    return chunks, lengths


def _prep(rng, S, N=5, T=700):
    chunks, lengths = _chunks(rng, S, N, T)
    return chunks, lengths, prepare_chunked(S, torch.from_numpy(chunks),
                                            torch.from_numpy(lengths), t_tile=256)


def _rand(rng, *shape):
    return torch.from_numpy(rng.random(shape).astype(np.float32) + 0.01)


# -- kernel level: stacked plain versions vs the single-model plain versions


@pytest.mark.parametrize("S,M", _SETS)
def test_prod_stacked_plain_equals_single(rng, S, M):
    _, tps = _members(S, M)
    _, _, prep = _prep(rng, S)
    _, tabs = TFB.stacked_tables(tps)
    got = TFB.oh_prod_stacked(prep.pair2, tabs)
    assert got.shape == (M, 4, prep.pair2.shape[1])
    for m in range(M):
        assert torch.equal(got[m], TFB.oh_prod_plain(prep.pair2, tabs[m]))
    reds = TFB.products_reduced_stacked(tps, prep.pair2)
    for p, red in zip(tps, reds):
        assert torch.equal(red, TFB.products_reduced(p, prep.pair2))


@pytest.mark.parametrize("S,M", _SETS)
def test_fwdbwd_stacked_plain_equals_single(rng, S, M):
    _, tps = _members(S, M)
    T = 700
    _, _, prep = _prep(rng, S, T=T)
    NL = prep.pair2.shape[1]
    _, tabs = TFB.stacked_tables(tps)
    a0, b0 = _rand(rng, M, 2, NL), _rand(rng, M, 2, NL)
    al, be = TFB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tabs, T)
    for m in range(M):
        a1, b1 = TFB.oh_fwdbwd_plain(prep.pair2, prep.pairn2, prep.lens2, a0[m], b0[m],
                                     tabs[m], T)
        assert torch.equal(al[m], a1) and torch.equal(be[m], b1)


@pytest.mark.parametrize("S,M", _SETS)
def test_seq_stats_stacked_plain_equals_single(rng, S, M):
    _, tps = _members(S, M)
    T = 700
    _, _, prep = _prep(rng, S, T=T)
    NL, K = prep.pair2.shape[1], 2 * S
    gts, tabs = TFB.stacked_tables(tps)
    al, be = TFB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, _rand(rng, M, 2, NL),
                                   _rand(rng, M, 2, NL), tabs, T)
    ef, er = _rand(rng, M, K, NL), _rand(rng, M, 2, NL)
    m0 = torch.from_numpy((rng.random((1, NL)) < 0.5).astype(np.float32))
    got = TFB.run_seq_stats_onehot_stacked(tps, al, be, prep.pair2, prep.lens2, er, ef, m0,
                                           prep.Tt)
    for m, p in enumerate(tps):
        want = TFB.run_seq_stats_onehot(p, al[m], be[m], prep.pair2, prep.lens2, gts[m], er[m],
                                        ef[m], m0, prep.Tt)
        assert all(torch.equal(g, w) for g, w in zip(got[m], want))


@pytest.mark.parametrize("S,M", _SETS)
def test_scoring_chain_stacked_equals_single(rng, S, M):
    _, tps = _members(S, M)
    _, _, prep = _prep(rng, S)
    NL = prep.pair2.shape[1]
    _, tabs = TFB.stacked_tables(tps)
    e = rng.random((M, 2, NL)).astype(np.float32) + 0.01
    enter = torch.from_numpy(e / e.sum(axis=1, keepdims=True))
    got = TL.oh_loglik(prep.pair2, enter, tabs)
    for m in range(M):
        assert torch.equal(got[m], TL.oh_loglik(prep.pair2, enter[m : m + 1],
                                                tabs[m : m + 1])[0])


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
def test_sequence_loglik_stacked_equals_single(rng, S, M):
    """A stacked group's scores (one B21, one scoring launch) equal each
    member's own sequence_loglik bit for bit, ragged length included."""
    _, tps = _members(S, M, seed=5)
    base = rng.integers(0, 4, size=3000).astype(np.uint8)
    obs = base if S == 4 else JC.recode_pairs(base)
    for length in (None, 2222):
        got = TL.sequence_loglik_stacked(tps, obs, length, lane_T=256)
        assert got == [TL.sequence_loglik(p, obs, length, lane_T=256) for p in tps]


# -- kernel level: stacked plain versions vs the JAX twins


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
def test_prod_stacked_matches_xla_twin(rng, S, M):
    jps, tps = _members(S, M)
    _, _, prep = _prep(rng, S)
    gts, tabs = TFB.stacked_tables(tps)
    want = jax.jit(JFB._xla_products_prob_stacked)(
        [jnp.asarray(t[:-1].numpy()) for t in tabs], jnp.asarray(prep.pair2.numpy()))
    for got, w in zip(TFB.products_reduced_stacked(tps, prep.pair2), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
def test_fwdbwd_stacked_matches_xla_twin(rng, S, M):
    _, tps = _members(S, M)
    T = 700
    _, _, prep = _prep(rng, S, T=T)
    NL = prep.pair2.shape[1]
    _, tabs = TFB.stacked_tables(tps)
    a0, b0 = _rand(rng, M, 2, NL), _rand(rng, M, 2, NL)
    al, be = TFB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tabs, T)
    nreal = S * S
    want = jax.jit(JFB._xla_fwdbwd_onehot_stacked, static_argnums=6)(
        [jnp.asarray(t.numpy()) for t in tabs],
        jnp.minimum(jnp.asarray(prep.pair2.numpy()), nreal),
        jnp.minimum(jnp.asarray(prep.pairn2.numpy()), nreal), jnp.asarray(prep.lens2.numpy()),
        [jnp.asarray(a.T.numpy()) for a in a0], [jnp.asarray(b.T.numpy()) for b in b0], T)
    for m, (ja, jb) in enumerate(want):
        np.testing.assert_allclose(al[m].numpy(), np.asarray(ja), rtol=1e-5)
        np.testing.assert_allclose(be[m].numpy(), np.asarray(jb), rtol=1e-5)


def test_seq_stats_stacked_matches_xla_twin(rng):
    """B25's plain version per member vs ``_xla_znorm_stats`` (the off-TPU
    lowering of the JAX stacked stats), with random enters and pair0."""
    jps, tps = _members(4, 3)
    T = 700
    _, _, prep = _prep(rng, 4, T=T)
    NL, K = prep.pair2.shape[1], 8
    gts, tabs = TFB.stacked_tables(tps)
    al, be = TFB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, _rand(rng, 3, 2, NL),
                                   _rand(rng, 3, 2, NL), tabs, T)
    ef, er = _rand(rng, 3, K, NL), _rand(rng, 3, 2, NL)
    m0 = torch.from_numpy((rng.random((1, NL)) < 0.5).astype(np.float32))
    got = TFB.run_seq_stats_onehot_stacked(tps, al, be, prep.pair2, prep.lens2, er, ef, m0,
                                           prep.Tt)
    twin = jax.jit(JFB._xla_znorm_stats)
    for m, jp in enumerate(jps):
        want = twin(jp, jnp.asarray(al[m].numpy()), jnp.asarray(be[m].numpy()),
                    jnp.asarray(prep.pair2.numpy()), jnp.asarray(prep.lens2.numpy()),
                    jnp.asarray(gts[m].numpy()), jnp.asarray(er[m].numpy()),
                    jnp.asarray(ef[m].numpy()), jnp.asarray(m0.numpy()))
        for g, w in zip(got[m], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# -- wrappers and routing


def test_stacked_wrappers_refuse_bad_members_and_operands(rng):
    _, four = _members(4, 2)
    _, pair = _members(16, 1)
    with pytest.raises(ValueError, match="one alphabet"):
        TFB.check_stacked_members(four + pair)
    with pytest.raises(ValueError, match="at least one"):
        TFB.check_stacked_members([])
    _, _, prep = _prep(rng, 4)
    # The split arm runs (B22, B23): each member's alphas equal the fused
    # arm's (B9 is B4's forward).
    ones = [torch.ones(8, prep.pair2.shape[1])] * 2
    streams = (prep.pair2, prep.esym2, prep.pairn2)
    al_s, _, _ = TFB.run_fb_kernels_onehot_stacked(four, prep.lens2, ones, ones, 700,
                                                   pair_esym=streams, fused=False)
    al_f, _, _ = TFB.run_fb_kernels_onehot_stacked(four, prep.lens2, ones, ones, 700,
                                                   pair_esym=streams)
    assert torch.equal(al_s, al_f)
    _, tabs = TFB.stacked_tables(four)
    with pytest.raises(ValueError):
        TFB.oh_prod_stacked(prep.pair2.long(), tabs)
    with pytest.raises(ValueError):
        TFB.oh_prod_stacked(prep.pair2, tabs[0])
    NL = prep.pair2.shape[1]
    with pytest.raises(ValueError):  # one member's entering vectors for two tables
        TFB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, _rand(rng, 1, 2, NL),
                              _rand(rng, 1, 2, NL), tabs, 700)
    with pytest.raises(ValueError):
        TL.oh_loglik(prep.pair2, _rand(rng, 3, 2, NL), tabs)
