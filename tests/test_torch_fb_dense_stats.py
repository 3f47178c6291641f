"""Expected counts on the dense engine: B20's plain version and the
chunked E-step ``fb_chunked.batch_stats(engine="pallas")`` vs the JAX
package's dense Pallas route (kernels in interpret mode) and the float64
textbook EM step, on the CPU.

B20 sums over time in another order than the JAX kernel, and the chains
feeding it round differently (XLA:CPU contracts into FMAs): counts agree
within rtol 1e-5 / atol 1e-3, logliks within rtol 1e-6, the M-step's
probabilities within atol 1e-5 of the oracle's.  The flagship's tables
through the dense engine give the reduced engine's counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_chunked
from cpgisland_tpu_torch.ops import fb_pallas as TFP
from cpgisland_tpu_torch.ops import prepared as TPR
from cpgisland_tpu_torch.train import baum_welch as TBW

from oracle import em_step_oracle
from test_torch_fb_dense import LANES, SHAPES, T, T_TILE, _case, _t

T_TILE_CHUNKED = 256


def _model(name):
    """(jax params, torch params) with identical float32 log tables:
    two_state, a random 5-state model over 3 symbols, a random 8-state
    one over 4, and the flagship."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "two_state":
        jp = JP.two_state_cpg()
    elif name == "flagship":
        jp = JP.durbin_cpg8()
    else:
        K, S = {"rand5": (5, 3), "rand8": (8, 4)}[name]
        A = rng.dirichlet(np.ones(K) * 0.5, size=K) + np.eye(K) * 4
        A /= A.sum(1, keepdims=True)
        jp = JHmm.from_probs(rng.dirichlet(np.ones(K)), A,
                             rng.dirichlet(np.ones(S), size=K))
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _probs(p):
    return [np.exp(np.asarray(x, np.float64)) for x in (p.log_pi, p.log_A, p.log_B)]


def _chunks(rng, S, N=6, T=1024):
    """N chunks with planted stretches rich in the upper half of the
    alphabet, ragged (an empty and a length-1 chunk), PAD past each length."""
    chunks = rng.integers(0, S, size=(N, T)).astype(np.uint8)
    a, m = T // 5, T // 2
    chunks[:, a : a + m] = rng.integers(S // 2, S, size=(N, m))
    lengths = np.array([T, 2 * T // 3, 0, 1, T - 3, T // 3], np.int32)[:N]
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    return chunks, lengths


@pytest.mark.parametrize("K,S", SHAPES)
def test_run_stats_kernel_matches_jax(K, S):
    """B20 on the JAX package's own streams: counts within rtol 1e-5 /
    atol 1e-3, the loglik within rtol 1e-6."""
    A, B, steps, lens, a0, beta0, _ = _case(K, S, 20 * K + S)
    alphas, _, betas = JFP._run_fb_kernels(jnp.asarray(A), jnp.asarray(B), jnp.asarray(steps),
                                           jnp.asarray(lens), jnp.asarray(a0),
                                           jnp.asarray(beta0), K, S, T_TILE, T)
    want = JFP._run_stats_kernel(jnp.asarray(B), alphas, betas, jnp.asarray(steps),
                                 jnp.asarray(lens), K, S, T_TILE)
    want = [np.asarray(x)[:, :LANES] for x in want]
    alphas, betas = (np.asarray(x) for x in (alphas, betas))
    got = TFP._run_stats_kernel(_t(B, False), _t(alphas), _t(betas), _t(steps), _t(lens),
                                T_TILE)
    got = [x.numpy() for x in got]
    assert [g.shape for g in got] == [(K * K, LANES), (K * S, LANES), (1, LANES)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-4)
    # The empty lane counts nothing; every emission bin sums to the length.
    assert not any(g[:, 0].any() for g in got)
    np.testing.assert_allclose(got[1].sum(0), lens[0, :LANES], rtol=1e-5)



# -- chunked E-step -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_state", "rand5", "rand8"])
def test_dense_batch_stats_matches_jax_and_oracle(rng, name):
    """B16 -> B18 -> B20 over ragged chunks (an empty and a length-1 one)
    vs ``batch_stats_pallas(onehot=False)``, and its M-step vs the float64
    textbook EM step."""
    jp, tp = _model(name)
    S = tp.n_symbols
    chunks, lengths = _chunks(rng, S)
    js = JFP.batch_stats_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                t_tile=T_TILE_CHUNKED, onehot=False)
    ts = fb_chunked.batch_stats(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                engine="pallas")
    for f in ("init", "trans", "emit"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-5, atol=1e-3)
    assert float(ts.loglik) == pytest.approx(float(js.loglik), rel=1e-6)
    assert int(ts.n_seqs) == int(js.n_seqs) == 5
    seqs = [chunks[i, : lengths[i]] for i in range(len(lengths)) if lengths[i]]
    pi, A, B, ll = em_step_oracle(*_probs(jp), seqs)
    new, _ = TBW.em_update(tp, ts)
    for got, want in zip((new.pi, new.A, new.B), (pi, A, B)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert float(ts.loglik) == pytest.approx(ll, rel=1e-5)


def test_flagship_dense_stats_equal_reduced(rng):
    """The flagship's tables through the dense kernels (engine="pallas")
    give the reduced engine's counts."""
    _, tp = _model("flagship")
    chunks, lengths = _chunks(rng, 4, T=2048)
    args = (tp, torch.from_numpy(chunks), torch.from_numpy(lengths))
    dense = fb_chunked.batch_stats(*args, engine="pallas")
    red = fb_chunked.batch_stats(*args, engine="onehot")
    for f in ("init", "trans", "emit", "loglik"):
        np.testing.assert_allclose(getattr(dense, f).numpy(), getattr(red, f).numpy(),
                                   rtol=1e-5, atol=1e-3)
    assert np.array_equal(dense.trans.numpy() == 0, red.trans.numpy() == 0)


def test_batch_stats_checks_engine_and_prep(rng):
    _, tp = _model("two_state")
    chunks, lengths = _chunks(rng, 4, N=3, T=64)
    c, n = torch.from_numpy(chunks), torch.from_numpy(lengths)
    prep = TPR.prepare_chunked(4, c, n, t_tile=fb_chunked.DEFAULT_T_TILE, onehot=False)
    assert prep.pair2 is None and prep.sel2 is not None
    held = fb_chunked.batch_stats(tp, c, n, prepared=prep, engine="pallas")
    inline = fb_chunked.batch_stats(tp, c, n, engine="pallas")
    assert all(torch.equal(getattr(held, f), getattr(inline, f))
               for f in ("init", "trans", "emit", "loglik"))
    with pytest.raises(ValueError, match="onehot=False"):
        fb_chunked.batch_stats(tp, c, n, prepared=prep, engine="onehot")
    with pytest.raises(ValueError, match="engine"):
        fb_chunked.batch_stats(tp, c, n, engine="xla")
