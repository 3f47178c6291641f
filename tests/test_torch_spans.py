"""The span-wise decode (``viterbi_sharded_spans``) of the PyTorch port
against the JAX package's and against the port's own one-shot decode.

On the CPU the port's kernel wrappers take their plain versions and the JAX
package runs its XLA twins on a one-device mesh, the port's geometry.  Both
do the same float32 adds and maxes in the same order, the sweep-A
composition runs in host float32 on both sides, and the stitching scans
share one combination tree, so paths are held BIT FOR BIT: span by span
against the JAX package, and concatenated against the one-shot decode of
the whole record (the JAX package's own contract,
``tests/test_parallel_decode.py``).  The random-model case is held to a
float64 Viterbi DP's optimum within abs 2e-2 / rel 1e-5, the JAX test's
tolerance.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.parallel import decode as JD
from cpgisland_tpu.parallel.mesh import SEQ_AXIS
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.parallel import decode as TD

SPAN = 4096
BLOCK = 64


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), (SEQ_AXIS,))


def _both(jp):
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _record(rng, T=5 * SPAN + 777):
    """Background with islands planted across two span boundaries."""
    obs = rng.choice([0, 3], size=T).astype(np.uint8)
    for mid in (SPAN, 2 * SPAN, 3 * SPAN + 100):
        obs[mid - 200 : mid + 200] = np.tile([1, 2], 200)
    return obs


def _jax_spans(jp, obs, engine, span=SPAN):
    return [np.asarray(p) for p in JD.viterbi_sharded_spans(
        jp, obs, span=span, mesh=_mesh1(), block_size=BLOCK, engine=engine)]


def _check(jp, tp, obs, jax_engine, span=SPAN):
    got = TD.viterbi_sharded_spans(tp, obs, span=span, block_size=BLOCK)
    want = _jax_spans(jp, obs, jax_engine, span)
    n = -(-obs.size // span)
    assert [p.shape[0] for p in got] == [span] * (n - 1) + [obs.size - (n - 1) * span]
    assert all(p.dtype == np.int32 for p in got)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    one = TD.viterbi_sharded(tp, obs, block_size=BLOCK)
    assert np.array_equal(np.concatenate(got), one)
    return np.concatenate(got)


@pytest.mark.parametrize("model", ["durbin8", "two_state"])
def test_spans_match_jax_and_one_shot(rng, model):
    """6 spans with a ragged tail: the flagship on the reduced engine (the
    JAX onehot twins), two_state on the dense one (the JAX "xla" twins,
    which the port's dense plain versions equal bit for bit)."""
    if model == "durbin8":
        jp, tp = _both(JP.durbin_cpg8())
        jax_engine = "onehot"
    else:
        jp, tp = _both(JP.two_state_cpg())
        jax_engine = "xla"
    obs = _record(rng)
    path = _check(jp, tp, obs, jax_engine)
    if model == "durbin8":
        # The islands planted across the boundaries come out whole.
        isl = path < 4
        for mid in (SPAN, 2 * SPAN):
            assert isl[mid - 150 : mid + 150].all()


def test_pad_first_record_demotes_whole_record(rng):
    """A record that opens with PAD (``invalid_symbols="mask"``) leaves the
    reduced engine's domain: the demotion applies to the whole record once,
    and the dense spans equal the JAX package's (its "xla" demotion)."""
    jp, tp = _both(JP.durbin_cpg8())
    obs = _record(rng, 3 * SPAN + 500)
    obs[:300] = 4
    obs[SPAN + 1000 : SPAN + 1300] = 4
    assert TD._engine_for_record("onehot", obs, tp) == "pallas"
    _check(jp, tp, obs, "onehot")


def test_span_boundary_inside_a_pad_run(rng):
    """A span that opens inside a PAD run: its entry group comes from the
    last real symbol before the run (``_prev_real_symbol`` scans back)."""
    jp, tp = _both(JP.durbin_cpg8())
    obs = _record(rng, 3 * SPAN + 321)
    obs[SPAN - 60 : SPAN + 40] = 4
    obs[2 * SPAN - 5 : 2 * SPAN + 700] = 4
    assert TD._prev_real_symbol(obs, SPAN, 4) == obs[SPAN - 61]
    _check(jp, tp, obs, "onehot")


def test_short_input_delegates(rng):
    _, tp = _both(JP.durbin_cpg8())
    obs = rng.integers(0, 4, size=1000).astype(np.uint8)
    spans = TD.viterbi_sharded_spans(tp, obs, span=SPAN, block_size=32)
    assert len(spans) == 1
    assert np.array_equal(spans[0], TD.viterbi_sharded(tp, obs, block_size=32))


def _f64_viterbi_score(jp, obs):
    lp, lA, lB = (np.asarray(x, np.float64) for x in (jp.log_pi, jp.log_A, jp.log_B))
    d = lp + lB[:, obs[0]]
    for o in obs[1:]:
        d = (d[:, None] + lA).max(axis=0) + lB[:, o]
    return float(d.max())


def _path_score(jp, obs, path):
    lp, lA, lB = (np.asarray(x, np.float64) for x in (jp.log_pi, jp.log_A, jp.log_B))
    return float(lp[path[0]] + lB[path[0], obs[0]] + lA[path[:-1], path[1:]].sum()
                 + lB[path[1:], obs[1:]].sum())


def test_random_model_spans_reach_f64_optimum(rng):
    pi = rng.dirichlet(np.ones(4))
    A = rng.dirichlet(np.ones(4), size=4)
    B = rng.dirichlet(np.ones(4), size=4)
    jp, tp = _both(JHmm.from_probs(pi, A, B))
    obs = rng.integers(0, 4, size=3000).astype(np.int32)
    spans = TD.viterbi_sharded_spans(tp, obs, span=1024, block_size=32)
    assert len(spans) == 3
    assert _path_score(jp, obs, np.concatenate(spans)) == pytest.approx(
        _f64_viterbi_score(jp, obs), abs=2e-2, rel=1e-5)
