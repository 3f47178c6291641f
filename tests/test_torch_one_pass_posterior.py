"""The one-pass posterior (B8 in place of B7 and B4) of the PyTorch port vs
the JAX package's ``seq_posterior_pallas(one_pass=True)``, on the CPU.

Both run their plain chains (the port's plain versions, the JAX XLA
twins).  The confidence is held within atol 2e-5 and the MPM paths
exactly; against the port's own two-pass arm the same bound holds (the
matrix arm carries other scales, exact for these scale-free outputs up to
rounding).  Span threading (a continuation span with an entering
direction and an exit direction) runs through the same glue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.parallel import posterior as TPO

ATOL = 2e-5
MASK = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)


def _obs(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    s[n // 3 : n // 3 + 700] = rng.choice(4, size=700, p=[0.1, 0.4, 0.4, 0.1])  # an island
    return s


# (symbols, length, lane_T, continuation span)
CASES = {"first": (3000, 3000, 256, False), "ragged": (2600, 2411, 512, False),
         "continuation": (2048, 2048, 256, True)}


def _span_kw(cont, seed):
    if not cont:
        return {}
    rng = np.random.default_rng(seed)
    return {"enter_dir": rng.random(8).astype(np.float32) + 0.01,
            "exit_dir": rng.random(8).astype(np.float32) + 0.01, "first": False,
            "prev_sym": 2}


@pytest.fixture(scope="module")
def jax_one_pass():
    jp = JP.durbin_cpg8()
    out = {}
    for name, (n, length, lane_T, cont) in CASES.items():
        kw = _span_kw(cont, n)
        if cont:
            kw = {"enter_dir": jnp.asarray(kw["enter_dir"]), "exit_dir": jnp.asarray(
                kw["exit_dir"]), "first": False, "prev_sym": 2}
        conf, path = JFP.seq_posterior_pallas(
            jp, jnp.asarray(_obs(n, n)), length, jnp.asarray(MASK), want_path=True,
            lane_T=lane_T, t_tile=128, onehot=True, one_pass=True, **kw)
        out[name] = (np.asarray(conf), np.asarray(path))
    return out


def _port(name, one_pass):
    jp = JP.durbin_cpg8()
    n, length, lane_T, cont = CASES[name]
    conf, path = fb_seq.seq_posterior(
        params_from_numpy(jp.log_pi, jp.log_A, jp.log_B), torch.from_numpy(_obs(n, n)), length,
        MASK, want_path=True, lane_T=lane_T, one_pass=one_pass, **_span_kw(cont, n))
    return conf.numpy(), path.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_one_pass_matches_jax(jax_one_pass, name):
    conf, path = _port(name, True)
    jconf, jpath = jax_one_pass[name]
    np.testing.assert_allclose(conf, jconf, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(path, jpath)


@pytest.mark.parametrize("name", list(CASES))
def test_one_pass_matches_the_two_pass_arm(name):
    conf1, path1 = _port(name, True)
    conf2, path2 = _port(name, False)
    np.testing.assert_allclose(conf1, conf2, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(path1, path2)


def test_confidence_only_and_posterior_sharded(monkeypatch):
    """The confidence-only route (no path) and the posterior_sharded entry
    with one_pass=True, against the two-pass arm; one_pass=None is the
    two-pass arm bit for bit."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 256)
    jp = JP.durbin_cpg8()
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    obs = _obs(3000, 7)
    c1, p1 = TPO.posterior_sharded(tp, obs, (0, 1, 2, 3), one_pass=True)
    c2, _ = TPO.posterior_sharded(tp, obs, (0, 1, 2, 3), one_pass=False)
    c0, _ = TPO.posterior_sharded(tp, obs, (0, 1, 2, 3))
    assert p1 is None and np.array_equal(c0, c2)
    np.testing.assert_allclose(c1, c2, atol=ATOL, rtol=0)
