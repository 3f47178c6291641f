"""Per-record scores off the flat one-hot batch (kernel B6's plain version)
against the JAX package.

On the CPU the port's B6 wrapper takes its plain version, and the JAX
package's onehot passes run their XLA twins (``_xla_backpointers_scores``).
Both do the same float32 adds and maxes in the same order, so the
backpointers, exit deltas, exit bits and the per-step chain max are held
BIT FOR BIT, and so are the per-record scores of the flat route (the same
epilogue over the same chain maxima and block offsets).  Against each
record's own ``viterbi_parallel`` score, whose rounding differs (the flat
score is a first difference of stream-magnitude chain maxima), scores are
held to the JAX tests' own bound, 1e-3 * N * T (``tests/test_passfusion.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu.ops import viterbi_parallel as JVP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH
from cpgisland_tpu_torch.ops import viterbi_parallel as TVP


def _onehot_model(rng, S=4):
    """Random one-hot model (K = 2S, scrambled groups), tie-free."""
    K = 2 * S
    perm = rng.permutation(K)
    sym_of_state = np.empty(K, dtype=np.int64)
    for s in range(S):
        sym_of_state[perm[2 * s]] = s
        sym_of_state[perm[2 * s + 1]] = s
    A = rng.dirichlet(np.ones(K), size=K) * np.exp(rng.normal(scale=1e-3, size=(K, K)))
    B = np.zeros((K, S))
    B[np.arange(K), sym_of_state] = 1.0
    return JHmm.from_probs(rng.dirichlet(np.ones(K)), A / A.sum(1, keepdims=True), B)


def _both(jp):
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _ragged_batch(rng, N, T):
    """A ragged batch: one record of length 2, one with a mid-record PAD run
    (symbol 7 clamps to PAD), the rest cut at random lengths."""
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.int32)
    chunks[1, T // 3 : T // 3 + 20] = 7
    lengths = rng.integers(T // 2, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    lengths[2] = 2
    return chunks, lengths


@pytest.mark.parametrize("bk,nb", [(37, 11), (8, 1), (64, 130)])
def test_plain_scores_kernel_matches_xla_twin(rng, bk, nb):
    """bp (unpacked), dexit, ebits and dmax2 bit for bit against
    ``_xla_backpointers_scores`` on a reset-renumbered stream; the first
    three also equal B2's plain version."""
    jp, tp = _both(_onehot_model(rng))
    steps = rng.integers(0, 5, size=(bk, nb)).astype(np.int32)
    rs = rng.random((bk, nb)) < 0.05
    tab, pair2 = jax.jit(lambda st, r: JOH._prepared(jp, st, 2, r)[2:5:2])(
        jnp.asarray(steps), jnp.asarray(rs))
    _, _, ttab, _, tpair2, _, te_out, nreal = TOH._prepared(
        tp, torch.from_numpy(steps), 2, torch.from_numpy(rs))
    tp2 = TOH._pad_pair_rows(tpair2, te_out, nreal)
    v = rng.normal(scale=2.0, size=(nb, 2)).astype(np.float32)
    dexit, ebits, bp2, dmax2 = jax.jit(JOH._xla_backpointers_scores)(tab, jnp.asarray(v), pair2)
    v_red = torch.from_numpy(v.T.copy())
    bp, tdexit, tebits, tdmax = TOH.oh_backpointers_scores(tp2, v_red, ttab)
    assert tdmax.shape == tp2.shape and tdmax.dtype == torch.float32
    assert np.array_equal(np.asarray(bp2), TOH._unpack_words(bp)[:bk].numpy())
    assert np.array_equal(np.asarray(dexit).T, tdexit.numpy())
    assert np.array_equal(np.asarray(ebits), tebits.numpy())
    assert np.array_equal(np.asarray(dmax2), tdmax[:bk].numpy())
    for a, b in zip(TOH.oh_backpointers(tp2, v_red, ttab), (bp, tdexit, tebits)):
        assert torch.equal(a, b)


def test_scores_wrapper_refuses_bad_operands():
    pair2 = torch.zeros((16, 4), dtype=torch.int32)
    tab = torch.zeros((24, 4), dtype=torch.float32)
    v = torch.zeros((2, 4), dtype=torch.float32)
    with pytest.raises(ValueError):
        TOH.oh_backpointers_scores(torch.zeros((12, 4), dtype=torch.int32), v, tab)  # bk % 8
    with pytest.raises(ValueError):
        TOH.oh_backpointers_scores(pair2, v.to(torch.float64), tab)
    with pytest.raises(ValueError):
        TOH.oh_backpointers_scores(pair2, torch.zeros((2, 5)), tab)


def test_scores_kernel_counts_launches_only_on_the_card(rng):
    """On the CPU the wrapper takes the plain version: no launch counted."""
    before = _kernels.launches["oh_backpointers_scores"]
    _, tp = _both(_onehot_model(rng))
    chunks = torch.from_numpy(rng.integers(0, 4, size=(3, 40)).astype(np.int32))
    TVP.viterbi_parallel_batch(tp, chunks, torch.tensor([40, 30, 2]), block_size=16)
    assert _kernels.launches["oh_backpointers_scores"] == before


@pytest.mark.parametrize("N,T,bk", [(5, 700, 128), (4, 520, 32), (6, 300, 64), (3, 90, 8)])
def test_decode_batch_flat_scores_match_jax(rng, N, T, bk):
    """Paths and scores bit for bit against the JAX flat route."""
    jp, tp = _both(_onehot_model(rng))
    chunks, lengths = _ragged_batch(rng, N, T)
    flat = jax.jit(JOH.decode_batch_flat, static_argnames=("block_size", "return_score"))
    pj, sj = flat(jp, jnp.asarray(chunks), jnp.asarray(lengths), block_size=bk,
                  return_score=True)
    pt, st = TOH.decode_batch_flat(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                   block_size=bk, return_score=True)
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert st.shape == (N,) and st.dtype == torch.float32
    assert np.array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("bk", [32, 64, 128])
def test_viterbi_parallel_batch_scores_match_jax(rng, bk):
    """``viterbi_parallel_batch(engine="onehot")`` returns (paths, scores):
    paths and scores equal the JAX function's bit for bit, and each score
    lies within 1e-3 * N * T of the record's own ``viterbi_parallel``
    score."""
    jp, tp = _both(_onehot_model(rng))
    N, T = 5, 600
    chunks, lengths = _ragged_batch(rng, N, T)
    pj, sj = JVP.viterbi_parallel_batch(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                        block_size=bk, engine="onehot")
    pt, st = TVP.viterbi_parallel_batch(tp, torch.from_numpy(chunks).to(torch.uint8),
                                        torch.from_numpy(lengths), block_size=bk)
    tol = 1e-3 * N * T
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())
    for i in range(N):
        L = int(lengths[i])
        o = np.where(np.arange(T) >= L, 4, np.minimum(chunks[i], 4)).astype(np.int32)
        _, s_ref = TVP.viterbi_parallel(tp, torch.from_numpy(o), block_size=bk)
        assert abs(float(st[i]) - float(s_ref)) <= tol, (i, float(st[i]), float(s_ref))


def test_score_arm_leaves_paths_unchanged(rng):
    """The dmax emission hangs off the recursion: the score arm's paths
    equal the path-only call's, on the flagship and on a random model."""
    for jp in (JP.durbin_cpg8(), _onehot_model(rng)):
        _, tp = _both(jp)
        chunks, lengths = _ragged_batch(rng, 4, 520)
        args = (tp, torch.from_numpy(chunks), torch.from_numpy(lengths))
        p_only = TOH.decode_batch_flat(*args, block_size=64)
        p_sc, _ = TOH.decode_batch_flat(*args, block_size=64, return_score=True)
        assert torch.equal(p_only, p_sc)
        assert torch.equal(TVP.viterbi_parallel_batch(*args, block_size=64, return_score=False),
                           p_only)
