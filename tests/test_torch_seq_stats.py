"""The whole-sequence E-step ``fb_seq.seq_stats`` of the PyTorch port vs
the JAX package's ``seq_stats_pallas``, on the CPU.

The port runs the plain versions of its kernels; the JAX package its XLA
twins.  Counts are held within rtol 1e-5 / atol 1e-3 and the loglik within
rel 1e-5 (the JAX package's own one-pass bound, tests/test_one_pass.py
``_assert_stats_close``): the two sum over time and lanes in different
orders, and XLA:CPU contracts multiply-adds into FMAs.  Each JAX result is
computed once per module (a few thousand symbols, short lanes) and shared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq

FIELDS = ("init", "trans", "emit", "loglik", "n_seqs")


def _tp(jp):
    return params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _onehot_s3():
    """A reduced model over a 3-symbol alphabet (two states per symbol): its
    stats take the scale-free assembly, outside B5's power-of-two domain."""
    rng = np.random.default_rng(5)
    K, S = 6, 3
    A = rng.random((K, K)) + 0.1
    A /= A.sum(1, keepdims=True)
    B = np.zeros((K, S))
    for k in range(K):
        B[k, k // 2] = 1.0
    pi = np.full(K, 1.0 / K)
    with np.errstate(divide="ignore"):
        return JHmm(jnp.asarray(np.log(pi), jnp.float32), jnp.asarray(np.log(A), jnp.float32),
                    jnp.asarray(np.maximum(np.log(B), -1e30), jnp.float32))


# name -> (JAX params, engine, one_pass, symbols, length, lane_T, t_tile)
CASES = {
    "flagship_two_pass": (JP.durbin_cpg8, "onehot", False, 3000, 3000, 256, 128),
    "flagship_ragged_one_pass": (JP.durbin_cpg8, "onehot", True, 3000, 2811, 256, 128),
    "two_state": (JP.two_state_cpg, "pallas", False, 3000, 2950, 256, 128),
    "dinuc_one_pass": (JP.dinuc_cpg, "onehot", True, 2048, 2048, 512, 512),
    "onehot_s3": (_onehot_s3, "onehot", False, 1500, 1500, 256, 128),
}


def _obs(name):
    _, _, _, n, _, _, _ = CASES[name]
    S = 16 if name.startswith("dinuc") else 3 if name == "onehot_s3" else 4
    return np.random.default_rng(len(name)).integers(0, S, size=n).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_stats():
    """Each case's JAX statistics, computed once."""
    out = {}
    for name, (make, engine, one_pass, n, length, lane_T, t_tile) in CASES.items():
        st = JFP.seq_stats_pallas(make(), jnp.asarray(_obs(name)), length, lane_T=lane_T,
                                  t_tile=t_tile, onehot=engine == "onehot", one_pass=one_pass)
        out[name] = {f: np.asarray(getattr(st, f), np.float64) for f in FIELDS}
    return out


def _port(name, one_pass=None):
    make, engine, op, n, length, lane_T, t_tile = CASES[name]
    st = fb_seq.seq_stats(_tp(make()), torch.from_numpy(_obs(name)), length, lane_T=lane_T,
                          engine=engine, one_pass=op if one_pass is None else one_pass,
                          t_tile=t_tile)
    return {f: getattr(st, f).double().numpy() for f in FIELDS}


def _assert_stats_close(got, want):
    for f in ("init", "trans", "emit"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-3, err_msg=f)
    np.testing.assert_allclose(got["loglik"], want["loglik"], rtol=1e-5)
    assert got["n_seqs"] == want["n_seqs"] == 1


@pytest.mark.parametrize("name", list(CASES))
def test_seq_stats_matches_jax(jax_stats, name):
    _assert_stats_close(_port(name), jax_stats[name])


@pytest.mark.parametrize("name", ["flagship_two_pass", "flagship_ragged_one_pass",
                                  "dinuc_one_pass"])
def test_one_pass_within_the_jax_bound_of_two_pass(name):
    _assert_stats_close(_port(name, one_pass=True), _port(name, one_pass=False))


@pytest.mark.parametrize("name", ["two_state", "onehot_s3"])
def test_one_pass_outside_its_gate_is_the_two_pass_arm(name):
    """The dense engine and a non-power-of-two alphabet ignore one_pass,
    bit for bit."""
    a, b = _port(name, one_pass=True), _port(name, one_pass=False)
    assert all(np.array_equal(a[f], b[f]) for f in FIELDS)


def test_empty_sequence_counts_nothing():
    st = fb_seq.seq_stats(_tp(JP.durbin_cpg8()), torch.full((64,), 4, dtype=torch.uint8), 0,
                          lane_T=64)
    assert int(st.n_seqs) == 0 and float(st.init.sum()) == 0.0
    assert float(st.trans.sum()) == 0.0 and float(st.emit.sum()) == 0.0
