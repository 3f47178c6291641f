"""The dense forward-backward engine at K = 6 and 7 vs the JAX package, on
the CPU.

At K >= 5 the card runs B16 and B18 as one chain split one thread a state,
bit for bit the sequential chains ``fb_pallas._fwd_chain_plain`` and
``_bwd_chain_plain`` (tests/test_torch_cuda.py); on the CPU the wrappers
take those plain chains.  Here they meet the JAX package at the K values
tests/test_torch_fb_dense.py (K = 2, 5, 8) leaves out: B16 then B18 (or
B19) through ``_run_fb_kernels`` against the JAX Pallas kernels in
interpret mode, within that file's tolerances (rtol 1e-5 / atol 1e-6
relative to each row's scale: XLA:CPU contracts multiply-adds into FMAs),
and a random 6-state model trained through ``train_file(engine="pallas")``
against the JAX ``train_file(engine="xla")``, within the EM parity bound
(logliks rtol 1e-5, probabilities atol 1e-5 with the same structural
zeros).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import load_text, params_from_numpy
from cpgisland_tpu_torch.ops import fb_pallas as TFP

# (K, S): the state-split chains' K values between the other file's 5 and 8,
# over the largest and the DNA alphabet.
SHAPES = [(6, 16), (7, 4)]
LANES, JAX_LANES = 12, 128
T_TILE, TP, T = 64, 192, 180
CHUNK = 4096


def _case(K, S, seed):
    """A seeded dense model and ragged chunked lanes (an empty one, a
    length-1 one, a full one; steps past each length zeroed as the prep
    leaves them; lanes LANES.. empty: the JAX lane pad)."""
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    B = rng.dirichlet(np.ones(S), size=K).astype(np.float32)
    steps = rng.integers(0, S, size=(TP, JAX_LANES)).astype(np.int32)
    lens = np.zeros((1, JAX_LANES), np.int32)
    lens[0, :LANES] = rng.integers(2, T + 1, size=LANES)
    lens[0, :4] = [0, 1, T, T - 1]
    steps[np.arange(TP)[:, None] >= lens] = 0
    a0 = (rng.random((K, JAX_LANES)) + 0.1).astype(np.float32)
    a0[:, lens[0] == 0] = 1.0 / K
    beta0 = (rng.random((K, JAX_LANES)) + 0.5).astype(np.float32)
    mask = (np.arange(K) % 2 == 0).astype(np.float32)
    return A, B, steps, lens, a0, beta0, mask


def _t(x, lanes=True):
    """The port's operand: the first LANES lanes, contiguous."""
    return torch.from_numpy(np.ascontiguousarray(x[..., :LANES] if lanes else x))


def _close_rows(got, want, axis, rtol=1e-5, atol=1e-6):
    """Within rtol, the absolute floor relative to each position's scale."""
    scale = np.maximum(np.abs(want).max(axis=axis, keepdims=True), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


@pytest.mark.parametrize("conf", [False, True])
@pytest.mark.parametrize("K,S", SHAPES)
def test_run_fb_kernels_matches_jax_wide(K, S, conf):
    """B16 then B18 (or B19 with ``conf_mask``): alphas, the row sums cs and
    the betas or the island confidence, carries past each length held."""
    A, B, steps, lens, a0, beta0, mask = _case(K, S, 100 * K + S)
    want = JFP._run_fb_kernels(jnp.asarray(A), jnp.asarray(B), jnp.asarray(steps),
                               jnp.asarray(lens), jnp.asarray(a0), jnp.asarray(beta0), K, S,
                               T_TILE, T, conf_mask=jnp.asarray(mask) if conf else None)
    want = [np.asarray(x)[..., :LANES] for x in want]
    got = TFP._run_fb_kernels(_t(A, False), _t(B, False), _t(steps), _t(lens), _t(a0),
                              _t(beta0), T, conf_mask=mask if conf else None)
    got = [x.numpy() for x in got]
    _close_rows(got[0], want[0], axis=1)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    if conf:
        assert got[2].shape == (TP, LANES)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
        assert not got[2][:, 0].any()  # the empty lane has no confidence
    else:
        _close_rows(got[2], want[2], axis=1)
    L = int(lens[0, 5])
    assert np.array_equal(got[0][L:, :, 5], np.broadcast_to(got[0][L - 1, :, 5], (TP - L, K)))


def _fasta(path, rng):
    """Records of 1.5-9 kb: an AT-leaning background with GC-rich runs."""
    with open(path, "w") as f:
        for r, n in enumerate([9000, 1500, 5200]):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            for a in range(300, n - 1200, 3000):
                s[a : a + 1000] = rng.choice(4, size=1000, p=[0.14, 0.36, 0.36, 0.14])
            f.write(f">rec{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    return str(path)


def test_train_file_six_states_matches_jax(tmp_path):
    """A random 6-state model (a structural zero in A) trained through the
    dense E-step, clean framing at 4 Ki chunks, 4 iterations: the JAX
    package's trajectory and a model dump that parses to its model."""
    rng = np.random.default_rng(6)
    K = 6
    A = rng.dirichlet(np.ones(K), size=K) + 2 * np.eye(K)
    A[2, 4] = 0.0
    A /= A.sum(1, keepdims=True)
    jp = JHmm.from_probs(rng.dirichlet(np.ones(K)), A, rng.dirichlet(np.ones(4), size=K))
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    fa = _fasta(tmp_path / "g.fa", rng)
    jm, tm = tmp_path / "j.txt", tmp_path / "t.txt"
    kw = dict(compat=False, chunk_size=CHUNK, num_iters=4, convergence=0.0)
    jr = JPL.train_file(fa, params=jp, engine="xla", model_out=str(jm), **kw)
    tr = TPL.train_file(fa, params=tp, engine="pallas", model_out=str(tm), device="cpu", **kw)
    assert tr.iterations == jr.iterations == 4
    np.testing.assert_allclose(tr.logliks, jr.logliks, rtol=1e-5)
    jl, tl = load_text(str(jm)), load_text(str(tm))
    assert tl.n_states == K
    for j, t in ((jl.pi, tl.pi), (jl.A, tl.A), (jl.B, tl.B)):
        j, t = np.asarray(j, np.float64), np.asarray(t, np.float64)
        np.testing.assert_allclose(t, j, atol=1e-5)
        assert np.array_equal(t == 0, j == 0)
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(tr.logliks, tr.logliks[1:]))
