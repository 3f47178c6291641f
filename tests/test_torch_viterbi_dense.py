"""The dense Viterbi engines of the PyTorch port vs the JAX package.

On the CPU the "pallas" engine's kernel wrappers (B13-B15) take their plain
PyTorch versions, and the "xla" engine is the port's plain twin of the JAX
package's lax.scan passes.  The JAX side runs its "xla" passes (which the
JAX package pins bit for bit against its Pallas kernels).  Max-plus is
adds and maxes only and both sides keep the same operands, so everything
here is held BIT FOR BIT: block products, prefix scans, exit deltas,
composition tables, paths and scores.  Path scores are also held to the
textbook float64 oracle (tests/oracle.py) within float32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import viterbi_pallas as JVPL
from cpgisland_tpu.ops import viterbi_parallel as JVP
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import HmmParams, params_from_numpy
from cpgisland_tpu_torch.ops import viterbi_pallas as TVPL
from cpgisland_tpu_torch.ops import viterbi_parallel as TVP
from cpgisland_tpu_torch.parallel import decode as TD

from oracle import viterbi_oracle


def _probs(rng, K, S=4):
    return (rng.dirichlet(np.ones(K)), rng.dirichlet(np.ones(K), size=K),
            rng.dirichlet(np.ones(S), size=K))


def _dense8(rng):
    """An 8-state model whose emissions are not one-hot pairs (each state
    emits two bases), with structural zeros in A and B."""
    pi, A, _ = _probs(rng, 8)
    A[0, 5] = A[3, 1] = 0.0
    A /= A.sum(1, keepdims=True)
    B = np.zeros((8, 4))
    for k in range(8):
        B[k, [k % 4, (k + 1) % 4]] = rng.dirichlet(np.ones(2))
    return pi, A, B


def _model(name, rng):
    """(jax params, torch params) with identical float32 log tables."""
    if name == "two_state":
        jp = JP.two_state_cpg()
    elif name == "dense8":
        jp = JHmm.from_probs(*_dense8(rng))
    else:
        jp = JHmm.from_probs(*_probs(rng, int(name[4:])))
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _steps(rng, bk, nb, S):
    """[bk, nb] transition symbols with PAD runs along the time axis."""
    steps = rng.integers(0, S, size=(bk, nb)).astype(np.int32)
    for _ in range(max(1, nb // 2)):
        k0, b, n = rng.integers(0, bk), rng.integers(0, nb), rng.integers(1, 40)
        steps[k0 : k0 + n, b] = S
    return steps


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


MODELS = ["rand2", "rand5", "rand8", "two_state", "dense8"]
GEOMETRIES = [(8, 1), (64, 3), (100, 130), (8, 130), (100, 1)]


# K = 2, 3, 5 and 8: B13's rows on 2, 4 (one idle) and 8 threads a lane.
PASS_MODELS = MODELS + ["rand3"]


@pytest.mark.parametrize("model", PASS_MODELS)
@pytest.mark.parametrize("bk,nb", GEOMETRIES)
def test_passes_match_jax_bitwise(model, bk, nb):
    """Plain B13/B14/B15 (through the pallas pass API) and the port's xla
    twin against the JAX xla passes: incl, offs, exit deltas, F and path."""
    rng = np.random.default_rng(PASS_MODELS.index(model) * 100_000 + bk * 1000 + nb)
    jp, tp = _model(model, rng)
    K, S = tp.n_states, tp.n_symbols
    steps = _steps(rng, bk, nb, S)
    v = rng.normal(scale=4.0, size=(nb, K)).astype(np.float32)
    v = np.maximum(v - v.max(1, keepdims=True), -1e30).astype(np.float32)
    exits = rng.integers(0, K, size=nb).astype(np.int32)

    ji, jo, jt = JVP._pass_products(jp, jnp.asarray(steps))
    jd, jF, jbps = JVP._pass_backpointers(jp, jnp.asarray(v), jnp.asarray(steps))
    jpath = JVP._pass_backtrace(jbps, jnp.asarray(exits))
    for engine in ("pallas", "xla"):
        products, backpointers, backtrace = TVP.get_passes(engine)
        ti, to, tt = products(tp, torch.from_numpy(steps))
        assert _eq(ji, ti) and _eq(jo, to) and _eq(jt, tt), engine
        td, tF, blob = backpointers(tp, torch.from_numpy(v), torch.from_numpy(steps))
        assert _eq(jd, td) and _eq(jF, tF), engine
        if engine == "xla":
            assert _eq(jbps, blob)
        else:
            # The packed word holds the JAX twin's K pointers, 3 bits each.
            bp, blob_k = blob
            assert blob_k == K
            unpacked = (bp[:, :, None] >> (3 * torch.arange(K))) & 7
            assert _eq(np.asarray(jbps).astype(np.int32), unpacked)
        assert _eq(jpath, backtrace(blob, torch.from_numpy(exits))), engine


def test_interpret_mode_kernels_match():
    """One tiny geometry against the JAX package's Pallas kernels
    themselves (interpret mode on the CPU): F, exit deltas and path."""
    rng = np.random.default_rng(16)
    jp, tp = _model("rand2", rng)
    steps = _steps(rng, 16, 3, 4)
    v = rng.normal(size=(3, 2)).astype(np.float32)
    exits = np.array([1, 0, 1], np.int32)
    ji, jo, _ = JVPL.pass_products(jp, jnp.asarray(steps))
    jd, jF, jblob = JVPL.pass_backpointers(jp, jnp.asarray(v), jnp.asarray(steps))
    jpath = JVPL.pass_backtrace(jblob, jnp.asarray(exits))
    ti, to, _ = TVPL.pass_products(tp, torch.from_numpy(steps))
    td, tF, tblob = TVPL.pass_backpointers(tp, torch.from_numpy(v), torch.from_numpy(steps))
    assert _eq(ji, ti) and _eq(jo, to) and _eq(jd, td) and _eq(jF, tF)
    assert _eq(jpath, TVPL.pass_backtrace(tblob, torch.from_numpy(exits)))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("T,block", [(1, 64), (9, 8), (777, 64), (3000, 256)])
def test_viterbi_parallel_matches_jax(model, T, block):
    """Whole-sequence decode, PAD first and mid-sequence: paths and scores
    equal the JAX xla engine's bit for bit; the score of a PAD-free
    sequence equals the float64 oracle's within float32 rounding."""
    rng = np.random.default_rng(T + block)
    jp, tp = _model(model, rng)
    S = tp.n_symbols
    obs = rng.integers(0, S, size=T).astype(np.int32)
    pj, sj = JVP.viterbi_parallel(jp, jnp.asarray(obs), block_size=block, engine="xla")
    for engine in ("pallas", "xla"):
        pt, st = TVP.viterbi_parallel(tp, torch.from_numpy(obs), block_size=block, engine=engine)
        assert _eq(pj, pt) and _eq(sj, st), engine
    lp, lA, lB = (np.exp(np.asarray(x, np.float64)) for x in (jp.log_pi, jp.log_A, jp.log_B))
    _, so = viterbi_oracle(lp, lA, lB, obs)
    np.testing.assert_allclose(float(sj), so, rtol=1e-5)
    padded = obs.copy()
    padded[: T // 3] = S
    padded[T // 2 : T // 2 + 5] = S
    pj, sj = JVP.viterbi_parallel(jp, jnp.asarray(padded), block_size=block, engine="xla")
    pt, st = TVPL.viterbi_pallas(tp, torch.from_numpy(padded), block_size=block)
    assert _eq(pj, pt) and _eq(sj, st)


@pytest.mark.parametrize("model", ["rand5", "two_state", "dense8"])
@pytest.mark.parametrize("T,block", [(1, 64), (300, 64), (2048, 512)])
def test_viterbi_parallel_batch_matches_jax(model, T, block):
    """The dense batch (records side by side as lanes) equals the JAX
    package's per-record vmap: paths and per-record scores, ragged lengths,
    an empty row and a PAD-first row included."""
    rng = np.random.default_rng(T * 7 + block)
    jp, tp = _model(model, rng)
    S = tp.n_symbols
    chunks = rng.integers(0, S, size=(5, T)).astype(np.uint8)
    chunks[1, : T // 4] = S
    lengths = np.array([T, max(1, T // 2), T, 0, max(1, T - 3)], np.int32)
    pj, sj = JVP.viterbi_parallel_batch(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                        block_size=block, engine="xla")
    for engine in ("pallas", "xla"):
        pt, st = TVP.viterbi_parallel_batch(tp, torch.from_numpy(chunks),
                                            torch.from_numpy(lengths), block_size=block,
                                            engine=engine)
        assert _eq(pj, pt) and _eq(sj, st), engine
    pt = TVPL.viterbi_pallas_batch(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                   block_size=block, return_score=False)
    assert _eq(pj, pt)


def test_two_state_preset_matches_jax():
    """Log values within one float32 ulp (the two packages' float32 log
    differ, see tests/test_torch_models.py); the dump of the same float32
    probabilities is byte-identical."""
    import io
    import types

    from cpgisland_tpu.models import hmm as JH
    from cpgisland_tpu_torch.models import hmm as TH

    jp, tp = JP.two_state_cpg(), TP.two_state_cpg()
    for name in ("log_pi", "log_A", "log_B"):
        np.testing.assert_array_max_ulp(np.asarray(getattr(jp, name)),
                                        getattr(tp, name).numpy(), maxulp=1)
    ours, theirs = io.StringIO(), io.StringIO()
    TH.dump_text(tp, ours)
    JH.dump_text(types.SimpleNamespace(pi=tp.pi.numpy(), A=tp.A.numpy(), B=tp.B.numpy(),
                                       n_states=2), theirs)
    assert ours.getvalue() == theirs.getvalue()
    assert tp.n_states == 2 and tp.n_symbols == 4


def test_supports_and_k_limit(rng):
    jbig = JHmm.from_probs(*_probs(rng, 9))
    big = params_from_numpy(jbig.log_pi, jbig.log_A, jbig.log_B)
    assert TVPL.supports(TP.two_state_cpg()) and TVPL.supports(TP.durbin_cpg8())
    assert not TVPL.supports(big)
    assert TVPL.PACKED_IDENTITY == JVPL.PACKED_IDENTITY
    with pytest.raises(ValueError, match="n_states <= 8"):
        TD.resolve_engine("pallas", big)
    with pytest.raises(ValueError, match="n_states <= 8"):
        TVPL.viterbi_pallas(big, torch.zeros(10, dtype=torch.int32))
    # K > 8 decodes on the xla twin, bit for bit with the JAX package.
    obs = rng.integers(0, 4, size=300).astype(np.int32)
    pj, sj = JVP.viterbi_parallel(jbig, jnp.asarray(obs), block_size=64, engine="xla")
    pt, st = TVP.viterbi_parallel(big, torch.from_numpy(obs), block_size=64, engine="xla")
    assert TD.resolve_engine("auto", big) == "xla"
    assert _eq(pj, pt) and _eq(sj, st)


def test_wrappers_check_operands():
    steps = torch.zeros((4, 3), dtype=torch.int32)
    logAT, logB = TVPL._tables(TP.two_state_cpg())
    with pytest.raises(ValueError):
        TVPL.dense_products(steps.to(torch.int64), logAT, logB)
    with pytest.raises(ValueError):
        TVPL.dense_backpointers(steps, torch.zeros((3, 2)), logAT, logB)
    with pytest.raises(ValueError):
        TVPL.dense_backtrace(steps, torch.zeros(2, dtype=torch.int32), 2)
    for K, seg in ((0, 0), (9, 0), (2, -1)):
        with pytest.raises(ValueError):
            TVPL.dense_backtrace(steps, torch.zeros(3, dtype=torch.int32), K, seg)


def _dense_params(rng):
    return HmmParams.from_probs(*_probs(rng, 4))


@pytest.mark.parametrize("requested,model,want", [
    ("auto", "flagship", "onehot"),
    ("auto", "two_state", "pallas"),
    ("auto", "dense4", "pallas"),
    ("auto", "k9", "xla"),
    ("xla", "flagship", "xla"),
    ("pallas", "flagship", "pallas"),
    ("pallas", "two_state", "pallas"),
    ("xla", "k9", "xla"),
    ("onehot", "flagship", "onehot"),
    ("onehot", "two_state", ValueError),
    ("pallas", "k9", ValueError),
    ("bogus", "flagship", ValueError),
])
def test_resolve_engine_rules(rng, requested, model, want):
    params = {
        "flagship": TP.durbin_cpg8(), "two_state": TP.two_state_cpg(),
        "dense4": _dense_params(rng), "k9": HmmParams.from_probs(*_probs(rng, 9)),
    }[model]
    if want is ValueError:
        with pytest.raises(ValueError):
            TD.resolve_engine(requested, params)
    else:
        assert TD.resolve_engine(requested, params) == want


@pytest.mark.parametrize("eng,first,model,want", [
    ("onehot", "real", "flagship", "onehot"),
    ("onehot", "pad", "flagship", "pallas"),  # PAD first: demoted
    ("onehot", "empty", "flagship", "pallas"),
    ("pallas", "pad", "two_state", "pallas"),
    ("xla", "pad", "flagship", "xla"),
    ("onehot", "pad", "onehot16", "xla"),  # no 3-bit packing: the xla twin
    ("onehot", "real", "onehot16", "onehot"),
])
def test_engine_for_record_rules(eng, first, model, want):
    if model == "onehot16":
        K, S = 16, 8
        B = np.zeros((K, S))
        B[np.arange(K), np.arange(K) % S] = 1.0
        params = HmmParams.from_probs(np.full(K, 1 / K), np.full((K, K), 1 / K), B)
    else:
        params = TP.durbin_cpg8() if model == "flagship" else TP.two_state_cpg()
    S = params.n_symbols
    obs = {"real": np.array([1, S, 2], np.uint8), "pad": np.array([S, 1, 2], np.uint8),
           "empty": np.zeros(0, np.uint8)}[first]
    assert TD._engine_for_record(eng, obs, params) == want


def test_pad_first_record_decodes_like_jax(rng):
    """A record whose first positions are PAD: the flagship's onehot engine
    demotes it to the dense kernels, and the path equals the JAX package's
    single-device dense decode bit for bit."""
    from jax.sharding import Mesh

    import jax
    from cpgisland_tpu.parallel import decode as JD
    from cpgisland_tpu.parallel.mesh import SEQ_AXIS

    jp = JP.durbin_cpg8()
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    obs = rng.integers(0, 4, size=5000).astype(np.uint8)
    obs[:700] = 4
    obs[2000:2100] = 4
    mesh1 = Mesh(np.array(jax.devices()[:1]), (SEQ_AXIS,))
    want = np.asarray(JD.viterbi_sharded(jp, obs, mesh=mesh1, engine="auto", block_size=256))
    got = TD.viterbi_sharded(tp, obs, engine="auto", block_size=256)
    assert got.dtype == np.int32 and np.array_equal(want, got)
    dev = TD.viterbi_sharded(tp, obs, engine="onehot", block_size=256, return_device=True)
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), got)
