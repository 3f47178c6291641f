"""Model core of the PyTorch port vs the JAX package: the reference text
dump, parameter carry-over, the preset, and the reduced-engine eligibility
oracle.

Tolerance, stated once: the text layer (number formatting, parsing, line
layout) is held byte for byte.  The two float32 transcendentals behind a
dump round trip (log on load, exp on dump) are not: XLA:CPU's float32
log/exp are not correctly rounded (on a million random inputs about 14% of
its log and 6% of its exp results sit one ulp away from the correctly
rounded value), while PyTorch's are to within 0.1%.  So log-space values
are held to one ulp, and byte identity of a dump is checked on identical
float32 probabilities.
"""

import io
import types

import numpy as np
import pytest

from cpgisland_tpu.models import hmm as JH
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.family import partition as JPart
from cpgisland_tpu_torch.family import partition as TPart
from cpgisland_tpu_torch.models import hmm as TH
from cpgisland_tpu_torch.models import presets as TP


def _doubles(rng):
    mags = 10.0 ** rng.uniform(-12, 9, size=400)
    vals = list(mags) + list(-mags[:50]) + list(rng.random(200))
    vals += [0.0, -0.0, 1.0, 0.05, 0.001, 0.00025, 0.0009999, 9999999.0, 1e7,
             1.5e300, float("inf"), float("-inf"), float("nan"), 0.9765624999999999]
    vals += [float(np.float32(v)) for v in rng.random(200)]  # f32 widened, as dumped
    return [float(v) for v in vals]


def test_java_double_str_matches_jax(rng):
    for v in _doubles(rng):
        assert TH.java_double_str(v) == JH.java_double_str(v), v


def _random_model(rng, K=8, S=4):
    pi = rng.dirichlet(np.ones(K))
    A = rng.dirichlet(np.ones(K), size=K)
    A[0, 3] = 0.0  # a structural zero -> LOG_ZERO
    A /= A.sum(axis=1, keepdims=True)
    A[1, :] = 0.00025  # Java's scientific range
    A[1, 0] = 1 - 0.00025 * (K - 1)
    B = np.zeros((K, S))
    B[np.arange(K), np.arange(K) % S] = 1.0
    return pi, A, B


def test_dump_text_bytes_equal_on_same_probabilities(rng):
    """Formatting layer: the port's dump of its params equals the JAX
    package's dump_text fed the same float32 probabilities."""
    for _ in range(5):
        tp = TH.HmmParams.from_probs(*_random_model(rng))
        ours = io.StringIO()
        TH.dump_text(tp, ours)
        theirs = io.StringIO()
        JH.dump_text(
            types.SimpleNamespace(
                pi=tp.pi.numpy(), A=tp.A.numpy(), B=tp.B.numpy(), n_states=tp.n_states
            ),
            theirs,
        )
        assert ours.getvalue() == theirs.getvalue()


def test_load_text_round_trip_matches_jax(rng, tmp_path):
    """Both packages parse a JAX-written dump to the same model (log values
    within one float32 ulp, LOG_ZERO entries identical), and the port's
    load -> dump -> load round trip is stable."""
    jp = JH.HmmParams.from_probs(*_random_model(rng))
    path = tmp_path / "m.txt"
    JH.dump_text(jp, str(path))
    j2 = JH.load_text(str(path))
    t2 = TH.load_text(str(path))
    for name in ("log_pi", "log_A", "log_B"):
        a = np.asarray(getattr(j2, name))
        b = getattr(t2, name).numpy()
        assert np.array_equal(a <= TH.LOG_ZERO / 2, b <= TH.LOG_ZERO / 2)
        real = a > TH.LOG_ZERO / 2
        np.testing.assert_array_max_ulp(a[real], b[real], maxulp=1)
        assert np.all(b[~real] == np.float32(TH.LOG_ZERO))
    first = io.StringIO()
    TH.dump_text(t2, first)
    again = io.StringIO()
    TH.dump_text(TH.load_text(io.StringIO(first.getvalue())), again)
    assert again.getvalue() == first.getvalue()
    lines = first.getvalue().splitlines()
    assert len(lines) == 24 and len(lines[1].split()) == 8 and len(lines[2].split()) == 4


def test_params_from_numpy_is_bitwise(rng):
    jp = JH.HmmParams.from_probs(*_random_model(rng))
    tp = TH.params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    for name in ("log_pi", "log_A", "log_B"):
        got = getattr(tp, name)
        assert got.dtype.is_floating_point and got.dtype.itemsize == 4
        assert np.array_equal(got.numpy(), np.asarray(getattr(jp, name)))
    assert tp.n_states == 8 and tp.n_symbols == 4


def test_durbin_preset_matches_jax():
    jp, tp = JP.durbin_cpg8(), TP.durbin_cpg8()
    for name in ("log_pi", "log_A", "log_B"):
        a = np.asarray(getattr(jp, name))
        b = getattr(tp, name).numpy()
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
    assert TP.HIDDEN_STATE_NAMES == JP.HIDDEN_STATE_NAMES


@pytest.mark.parametrize("case", ["flagship", "dense", "skewed", "scrambled"])
def test_reduced_eligible_matches_jax(rng, case):
    if case == "flagship":
        jp = JP.durbin_cpg8()
    else:
        K, S = (4, 4) if case == "dense" else (4, 2) if case == "skewed" else (8, 4)
        B = rng.dirichlet(np.ones(S), size=K)
        if case == "skewed":
            B = np.zeros((K, S))
            B[:, 0] = 1.0
        if case == "scrambled":
            B = np.zeros((K, S))
            B[rng.permutation(K), np.arange(K) % S] = 1.0
        jp = JH.HmmParams.from_probs(
            rng.dirichlet(np.ones(K)), rng.dirichlet(np.ones(K), size=K), B
        )
    tp = TH.params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    assert TPart.reduced_eligible(tp) == JPart.reduced_eligible(jp)
    assert TPart.reduced_eligible(tp) == (case in ("flagship", "scrambled"))
