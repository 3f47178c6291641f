"""The reduced one-hot Viterbi engine of the PyTorch port vs the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch version, and the JAX
package's onehot passes run their XLA twins (``_xla_products``,
``_xla_backpointers``, ``_xla_backtrace``).  Both perform the same float32
adds and maxes in the same order, and the stitching scans use the same
combination tree, so on the same block geometry everything here is held
BIT FOR BIT.  Across geometries (the JAX package's 8-device virtual mesh vs
the port's one device) the per-block normalizers round differently, and
paths are held to the engine's tie contract: equal, or else an equal
float64 re-score (both then true argmaxes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu.ops import viterbi_parallel as JVP
from cpgisland_tpu.parallel import decode as JD
from cpgisland_tpu.parallel.mesh import SEQ_AXIS
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH
from cpgisland_tpu_torch.ops import viterbi_parallel as TVP
from cpgisland_tpu_torch.parallel import decode as TD


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


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


def _path_score(jp, obs, path):
    """float64 score of a state path (PAD steps are identity)."""
    lp, lA, lB = (np.asarray(x, np.float64) for x in (jp.log_pi, jp.log_A, jp.log_B))
    S = lB.shape[1]
    s = lp[path[0]] + (lB[path[0], obs[0]] if obs[0] < S else 0.0)
    for t in range(1, len(obs)):
        if obs[t] >= S:
            assert path[t] == path[t - 1]
            continue
        s += lA[path[t - 1], path[t]] + lB[path[t], obs[t]]
    return s


# -- tables and pair streams (e) ---------------------------------------------


@pytest.mark.parametrize("resets", [False, True])
@pytest.mark.parametrize("bk,nb,prev0", [(37, 11, 2), (8, 1, 0), (64, 5, 3), (3, 40, 1)])
def test_prepare_pairs_matches(rng, resets, bk, nb, prev0):
    steps = rng.integers(0, 4, size=(bk, nb)).astype(np.int32)
    steps[rng.random((bk, nb)) < 0.2] = 4  # scattered PADs
    steps[:, nb // 2] = 4  # an all-PAD block: the cross-block seed
    rs = rng.random((bk, nb)) < 0.1 if resets else None
    a = jax.jit(lambda st, r: JOH.prepare_pairs(4, st, prev0, r)[:3])(
        jnp.asarray(steps), None if rs is None else jnp.asarray(rs))
    b = TOH.prepare_pairs(4, torch.from_numpy(steps), prev0,
                          None if rs is None else torch.from_numpy(rs))
    for x, y in zip(a, b[:3]):
        assert _eq(x, y) and y.dtype == torch.int32
    assert b[3] == (20 if resets else 16)
    assert b[0].is_contiguous()


@pytest.mark.parametrize("resets", [False, True])
def test_tables_match(rng, resets):
    jp, tp = _both(_onehot_model(rng))
    steps = rng.integers(0, 5, size=(16, 6)).astype(np.int32)
    rs = rng.random((16, 6)) < 0.2 if resets else None
    a = jax.jit(lambda st, r: JOH._prepared(jp, st, 1, r)[:4])(
        jnp.asarray(steps), None if rs is None else jnp.asarray(rs))
    b = TOH._prepared(tp, torch.from_numpy(steps), 1, None if rs is None else torch.from_numpy(rs))
    assert _eq(a[1], b[1])  # group table
    assert _eq(a[2], b[2]) and b[2].dtype == torch.float32  # pair table
    assert _eq(a[3], b[3])  # pair -> exit-group ids
    assert _eq(JOH.pair_exit_syms(4), TOH.pair_exit_syms(4))


def test_scatters_match(rng):
    jp, tp = _both(_onehot_model(rng))
    gt_j, gt_t = JOH._groups(jp), TOH._groups(tp)
    nb = 9
    e_in = rng.integers(0, 4, size=nb).astype(np.int32)
    e_out = rng.integers(0, 4, size=nb).astype(np.int32)
    red = rng.normal(size=(nb, 2, 2)).astype(np.float32)
    ein_t, eout_t = torch.from_numpy(e_in), torch.from_numpy(e_out)
    assert _eq(JOH._scatter_products(jnp.asarray(red), gt_j, e_in, e_out, 8),
               TOH._scatter_products(torch.from_numpy(red), gt_t, ein_t, eout_t, 8))
    assert _eq(JOH._scatter_vec(jnp.asarray(red[:, 0]), gt_j, e_out, 8),
               TOH._scatter_vec(torch.from_numpy(red[:, 0].copy()), gt_t, eout_t, 8))
    eb = rng.integers(0, 4, size=nb).astype(np.int32)
    assert _eq(JOH._scatter_ftab(jnp.asarray(eb), gt_j, e_in, e_out, 8),
               TOH._scatter_ftab(torch.from_numpy(eb), gt_t, ein_t, eout_t, 8))


# -- plain kernel versions vs the XLA twins (f) ------------------------------


@pytest.mark.parametrize("bk,nb", [(37, 11), (8, 1), (61, 130), (128, 3)])
def test_plain_kernels_match_xla_twins(rng, bk, nb):
    """Ragged bk is padded to a multiple of 8 with identity pairs (as the
    passes do); outputs are held bitwise on the real steps."""
    jp, tp = _both(_onehot_model(rng))
    steps = rng.integers(0, 5, size=(bk, nb)).astype(np.int32)
    rs = rng.random((bk, nb)) < 0.05
    tab, idtab, pair2 = jax.jit(lambda st, r: JOH._prepared(jp, st, 2, r)[2:5])(
        jnp.asarray(steps), jnp.asarray(rs))
    _, _, ttab, tidtab, tpair2, _, te_out, nreal = TOH._prepared(
        tp, torch.from_numpy(steps), 2, torch.from_numpy(rs))
    tp2 = TOH._pad_pair_rows(tpair2, te_out, nreal)
    assert tp2.shape[0] % 8 == 0 and tp2.shape[0] - bk < 8

    red = TOH.oh_products(tp2, ttab)
    assert _eq(np.asarray(jax.jit(JOH._xla_products)(tab, pair2)).reshape(nb, 4).T, red)

    v = rng.normal(scale=2.0, size=(nb, 2)).astype(np.float32)
    dexit, ebits, bp2 = jax.jit(JOH._xla_backpointers)(tab, jnp.asarray(v), pair2)
    bp, tdexit, tebits = TOH.oh_backpointers(tp2, torch.from_numpy(v.T.copy()), ttab)
    assert bp.shape == (tp2.shape[0] // 8, nb) and bp.dtype == torch.int32
    assert _eq(bp2, TOH._unpack_words(bp)[:bk])
    assert _eq(np.asarray(dexit).T, tdexit)
    assert _eq(ebits, tebits)

    exit_bits = rng.integers(0, 2, size=nb).astype(np.int32)
    path = jax.jit(JOH._xla_backtrace)(bp2, pair2, idtab, jnp.asarray(exit_bits))
    tpath = TOH.oh_backtrace(bp, tp2, tidtab, torch.from_numpy(exit_bits))
    assert _eq(path, tpath[:bk])


def test_wrappers_refuse_bad_operands():
    pair2 = torch.zeros((16, 4), dtype=torch.int32)
    tab = torch.zeros((24, 4), dtype=torch.float32)
    with pytest.raises(ValueError):
        TOH.oh_products(pair2.to(torch.int64), tab)
    with pytest.raises(ValueError):
        TOH.oh_products(torch.zeros((12, 4), dtype=torch.int32), tab)  # bk % 8
    with pytest.raises(ValueError):
        TOH.oh_products(pair2.T.contiguous().T, tab)  # not contiguous
    with pytest.raises(ValueError):
        TOH.oh_backpointers(pair2, torch.zeros((2, 5)), tab)
    with pytest.raises(ValueError):
        TOH.oh_products(pair2.to("meta"), tab.to("meta"))  # neither CPU nor CUDA


def test_kernel_launcher_refuses_without_card_or_compiler(monkeypatch, tmp_path):
    """The launcher takes CUDA tensors only, and a missing nvcc is a clear
    error (the build happens at first launch, never at import)."""
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.launch("oh_products", t, t, t, bk=8, nb=1, nP=1)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.library()
    assert all(n == 0 for n in _kernels.launches.values())


# -- stitching scans (g) ------------------------------------------------------


@pytest.mark.parametrize("nb", [1, 2, 3, 16, 33])
def test_scan_block_products_bitwise(rng, nb):
    P = (rng.normal(size=(nb, 8, 8)) * 40).astype(np.float32)
    P[rng.random(P.shape) < 0.3] = -1e30
    i1, o1 = jax.jit(JVP.scan_block_products)(jnp.asarray(P))
    i2, o2 = TVP.scan_block_products(torch.from_numpy(P))
    assert _eq(i1, i2) and _eq(o1, o2)
    F = rng.integers(0, 8, size=(nb, 8)).astype(np.int32)
    assert _eq(jax.jit(JVP._suffix_compositions)(jnp.asarray(F)),
               TVP._suffix_compositions(torch.from_numpy(F)))
    v0 = rng.normal(size=8).astype(np.float32)
    for x, y in zip(jax.jit(JVP._enter_vectors)(jnp.asarray(v0), i1, o1),
                    TVP._enter_vectors(torch.from_numpy(v0), i2, o2)):
        assert _eq(x, y)


# -- whole decodes (h) --------------------------------------------------------


@pytest.mark.parametrize("T,block", [(1, 8), (5, 4), (64, 8), (257, 32), (2000, 256), (5000, 512)])
def test_viterbi_parallel_matches_jax(rng, T, block):
    jp, tp = _both(_onehot_model(rng))
    obs = rng.integers(0, 4, size=T).astype(np.int32)
    if T > 100:
        obs[T // 3 : T // 3 + 30] = 4  # mid-sequence PAD run
        obs[-7:] = 4  # tail PADs
    pj, sj = JVP.viterbi_parallel(jp, jnp.asarray(obs), block_size=block, engine="onehot")
    pt, st = TVP.viterbi_parallel(tp, torch.from_numpy(obs), block_size=block)
    assert _eq(pj, pt) and pt.dtype == torch.int32
    assert float(sj) == float(st)


def test_decode_batch_flat_fuzz_geometries(rng):
    """The fuzz geometries of the JAX package's own flat-batch test: random
    record counts, lengths and blocks; every path bitwise equal to its flat
    decoder (behind the jitted viterbi_parallel_batch)."""
    jp, tp = _both(_onehot_model(rng))
    for _ in range(4):
        N = int(rng.integers(1, 7))
        T = int(rng.integers(2, 900))
        bk = int(2 ** rng.integers(3, 8))
        chunks = rng.integers(0, 4, size=(N, T)).astype(np.int32)
        lengths = rng.integers(1, T + 1, size=N).astype(np.int32)
        a = JVP.viterbi_parallel_batch(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                       block_size=bk, return_score=False, engine="onehot")
        b = TOH.decode_batch_flat(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                  block_size=bk)
        assert _eq(a, b), (N, T, bk)
        c = TVP.viterbi_parallel_batch(tp, torch.from_numpy(chunks).to(torch.uint8),
                                       torch.from_numpy(lengths), block_size=bk,
                                       return_score=False)
        assert torch.equal(b, c)


def test_viterbi_parallel_batch_refuses_scores(rng):
    """The flat onehot batch once refused per-record scores; it now returns
    them through B6's plain version.  Held against the JAX function on the
    same batch: paths and scores bit for bit."""
    jp, tp = _both(_onehot_model(rng))
    chunks = rng.integers(0, 4, size=(2, 16)).astype(np.uint8)
    lengths = np.array([16, 9], np.int32)
    pj, sj = JVP.viterbi_parallel_batch(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                        block_size=8, engine="onehot")
    pt, st = TVP.viterbi_parallel_batch(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                        block_size=8, return_score=True)
    assert _eq(pj, pt)
    assert np.array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("T", [3000])
def test_viterbi_sharded_matches_jax(rng, T):
    """Same geometry (the JAX package on a one-device mesh): bitwise.
    The JAX package's default 8-device mesh: the tie contract."""
    jp, tp = _both(JP.durbin_cpg8())
    obs = rng.integers(0, 4, size=T).astype(np.uint8)
    obs[100:140] = 4
    mesh1 = Mesh(np.array(jax.devices()[:1]), (SEQ_AXIS,))
    a1 = JD.viterbi_sharded(jp, obs, mesh=mesh1, engine="onehot", block_size=256)
    b = TD.viterbi_sharded(tp, obs, engine="onehot", block_size=256)
    assert b.dtype == np.int32 and _eq(a1, b)
    a8 = np.asarray(JD.viterbi_sharded(jp, obs, engine="onehot", block_size=256))
    if not np.array_equal(a8, b):
        assert _path_score(jp, obs, a8) == _path_score(jp, obs, b)


def test_engine_resolution(rng):
    _, tp = _both(JP.durbin_cpg8())
    assert TD.resolve_engine("auto", tp) == "onehot"
    dense = params_from_numpy(*(np.log(rng.dirichlet(np.ones(4), size=n)).astype(np.float32)
                                for n in (1, 4, 4)))
    dense = params_from_numpy(dense.log_pi[0], dense.log_A, dense.log_B)
    # The dense engines: 'auto' takes the dense kernels for K <= 8.
    for eng, want in (("auto", "pallas"), ("xla", "xla"), ("pallas", "pallas")):
        assert TD.resolve_engine(eng, dense) == want
    with pytest.raises(ValueError):
        TD.resolve_engine("onehot", dense)
    # PAD first: the reduced engine hands the record to the dense kernels.
    obs = np.array([4, 0, 1, 2, 2, 1], np.uint8)
    assert TD._engine_for_record("onehot", obs, tp) == "pallas"
    path = TD.viterbi_sharded(tp, obs)
    assert np.array_equal(path, TD.viterbi_sharded(tp, obs, engine="xla"))
    assert TD._prev_real_symbol(np.array([2, 4, 4, 1, 4], np.uint8), 3, 4) == 2
    assert TD._prev_real_symbol(np.array([4, 4], np.uint8), 1, 4) == 0
