"""The stacked modules of the port vs the sequential arm and the JAX
package: ``posterior_sharded_stacked`` (B21 and B24 under it),
``fb_chunked.batch_stats_stacked`` and ``FamilyEStep`` (B24 and B25), and
``fit_family``.

On the CPU the stacked kernels run their plain versions, which equal M
single-model plain runs bit for bit (``tests/test_torch_stacked.py``), so
every stacked module here equals M sequential runs bit for bit.  Against
the JAX package's ``fit_family`` (its off-TPU stacked E-step runs the XLA
twins) the trajectory agrees within rtol 1e-5.  Member sets as in
``tests/test_torch_stacked.py``, drawn by the JAX package and carried
across as arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.train import backends as JB
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_chunked, fb_seq
from cpgisland_tpu_torch.parallel import posterior as post
from cpgisland_tpu_torch.train import baum_welch
from cpgisland_tpu_torch.train.backends import FamilyEStep, LocalBackend, fit_family
from cpgisland_tpu_torch.utils import chunking


def _members(S, M, seed=0):
    """(JAX params list, port params list) of M members of one alphabet."""
    first = JP.durbin_cpg8() if S == 4 else JP.dinuc_cpg()
    jps = [first] + [JP.random_hmm(jax.random.PRNGKey(seed + m), 2 * S, S, partition=2)
                     for m in range(1, M)]
    return jps, [params_from_numpy(p.log_pi, p.log_A, p.log_B) for p in jps]


def _chunks(rng, S, N, T):
    """Seeded [N, T] chunks of the alphabet (pair-recoded at S = 16):
    ragged lengths, an empty lane, PAD tails."""
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    if S == 16:
        chunks = JC.recode_pairs(chunks.ravel()).reshape(N, T)
    lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    if N > 2:
        lengths[1] = 0
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    return chunks, lengths


@pytest.fixture
def short_lanes(monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 512)


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
@pytest.mark.parametrize("want_path", [True, False])
def test_posterior_stacked_equals_sequential(rng, short_lanes, S, M, want_path):
    """posterior_sharded_stacked (and seq_posterior_stacked under it) equals
    M posterior_sharded(engine="onehot") calls bit for bit, on a shared
    placed stream padded past the record as compare places it."""
    _, tps = _members(S, M, seed=11)
    base = rng.choice(4, size=4000, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    base[1000:1800] = rng.choice(4, size=800, p=[0.15, 0.35, 0.35, 0.15])
    obs = base if S == 4 else JC.recode_pairs(base)
    states = [tuple(range(S))] + [tuple(range(0, 2 * S, 3))] * (M - 1)
    placed = post.place_record_span(tps[0], obs, pad_to=1 << 13)
    conf, path = post.posterior_sharded_stacked(tps, obs, states, want_path=want_path,
                                                placed=placed)
    assert conf.shape == (M, obs.size) and (path is None) == (not want_path)
    for m, p in enumerate(tps):
        c1, p1 = post.posterior_sharded(p, obs, states[m], engine="onehot", want_path=want_path,
                                        placed=placed)
        np.testing.assert_array_equal(conf[m], c1)
        if want_path:
            np.testing.assert_array_equal(path[m], p1)


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
def test_batch_stats_stacked_and_family_estep_equal_local_backend(rng, S, M):
    _, tps = _members(S, M, seed=21)
    chunks, lengths = _chunks(rng, S, 6, 900)
    ch, ln = torch.from_numpy(chunks), torch.from_numpy(lengths)
    solo = []
    for p in tps:
        backend = LocalBackend(engine="onehot")
        prep = backend.prepare_streams(p, ch, ln)
        solo.append(backend(p, ch, ln, prepared=prep))
    runs = [fb_chunked.batch_stats_stacked(tps, ch, ln)]
    for stacked in (True, False):
        estep = FamilyEStep(stacked=stacked)
        runs.append(estep(tps, ch, ln, prepared=estep.prepare_streams(tps, ch, ln)))
    for got in runs:
        for g, w in zip(got, solo):
            for f in ("init", "trans", "emit", "loglik", "n_seqs"):
                assert torch.equal(getattr(g, f), getattr(w, f)), f


def test_family_estep_validates_members():
    _, four = _members(4, 2)
    with pytest.raises(ValueError, match="reduced-stats-eligible"):
        FamilyEStep().validate(four + [params_from_numpy(*(
            np.asarray(x) for x in (lambda p: (p.log_pi, p.log_A, p.log_B))(JP.two_state_cpg())))])
    # The split arm runs (B22, B23, B12 per member).
    chunks, lengths = _chunks(np.random.default_rng(5), 4, 3, 300)
    stats = FamilyEStep(fuse_fb=False)(four, torch.from_numpy(chunks), torch.from_numpy(lengths))
    assert len(stats) == 2 and all(bool(torch.isfinite(st.loglik)) for st in stats)


def _train_batch(rng):
    s = rng.choice(4, size=7000, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    s[2000:3500] = rng.choice(4, size=1500, p=[0.15, 0.35, 0.35, 0.15])
    return chunking.frame(s, 2048)


def test_fit_family_equals_independent_fits(rng):
    """5 lockstep iterations: every member's loglik trajectory and final
    model equal its own baum_welch.fit (onehot, convergence 0) bit for
    bit."""
    _, tps = _members(4, 3, seed=31)
    chunked = _train_batch(rng)
    fitted, hist = fit_family(tps, chunked.chunks, chunked.lengths, n_iter=5)
    assert hist.shape == (5, 3) and hist.dtype == np.float64
    for m, p in enumerate(tps):
        solo = baum_welch.fit(p, chunked, num_iters=5, convergence=0.0, engine="onehot")
        np.testing.assert_array_equal(hist[:, m], np.asarray(solo.logliks, np.float64))
        for f in ("log_pi", "log_A", "log_B"):
            assert torch.equal(getattr(fitted[m], f), getattr(solo.params, f)), f
    empty_fit, empty_hist = fit_family(tps, chunked.chunks, chunked.lengths, n_iter=0)
    assert empty_hist.shape == (0, 3) and len(empty_fit) == 3


def test_fit_family_matches_jax(rng):
    """The port's fit_family trajectory vs the JAX package's (its off-TPU
    stacked E-step runs the XLA twins): logliks within rtol 1e-5, models
    within atol 1e-5."""
    jps, tps = _members(4, 2, seed=41)
    chunked = _train_batch(rng)
    jfit, jhist = JB.fit_family(jps, jnp.asarray(chunked.chunks), jnp.asarray(chunked.lengths),
                                n_iter=5)
    tfit, thist = fit_family(tps, chunked.chunks, chunked.lengths, n_iter=5)
    np.testing.assert_allclose(thist, np.asarray(jhist), rtol=1e-5)
    for j, t in zip(jfit, tfit):
        for f in ("pi", "A", "B"):
            np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                       atol=1e-5)
