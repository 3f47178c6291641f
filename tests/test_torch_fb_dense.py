"""The dense forward-backward kernels' plain versions (B16-B19) vs the JAX
package's Pallas kernels, on the CPU (B20 and the E-step:
tests/test_torch_fb_dense_stats.py).

On the CPU the port's wrappers (``ops.fb_pallas.fb_fwd`` and the rest)
take their plain PyTorch versions; the JAX package runs its Pallas kernels
in interpret mode, as its own tests do off-TPU.  The JAX side pads lanes
to its 128-lane tile: the port runs the handful of real lanes and the
comparison reads those.  XLA:CPU contracts multiply-adds into FMAs and
reduces in its own order, so the two agree within rtol 1e-5 / atol 1e-6 on
the streams and the confidence (relative to each row's scale).  Each JAX
call here costs about 2 s in interpret mode whatever its size, so every
case makes one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_pallas as TFP

# (K, S) cases: the two_state shape, an odd K over 3 symbols, the flagship's K.
SHAPES = [(2, 4), (5, 3), (8, 4)]
LANES, JAX_LANES = 12, 128
T_TILE, TP, T = 64, 192, 180


def _case(K, S, seed):
    """A seeded dense model and a chunked lane layout: ragged lanes (an
    empty one, a length-1 one, a full one), steps past each length zeroed
    as the prep leaves them, lanes LANES.. empty (the JAX lane pad)."""
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


def _jax_fb(A, B, steps, lens, a0, beta0, K, S, mask=None):
    out = JFP._run_fb_kernels(jnp.asarray(A), jnp.asarray(B), jnp.asarray(steps),
                              jnp.asarray(lens), jnp.asarray(a0), jnp.asarray(beta0), K, S,
                              T_TILE, T, conf_mask=None if mask is None else jnp.asarray(mask))
    return [np.asarray(x)[..., :LANES] for x in out]


def _close_rows(got, want, axis, rtol=1e-5, atol=1e-6):
    """Within rtol, with the absolute floor relative to each position's
    scale (the max over ``axis``): stream entries far below their row's
    largest differ in the last bits the FMA contraction moves."""
    scale = np.maximum(np.abs(want).max(axis=axis, keepdims=True), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


@pytest.mark.parametrize("conf", [False, True])
@pytest.mark.parametrize("K,S", SHAPES)
def test_run_fb_kernels_matches_jax(K, S, conf):
    """B16 then B18 (or B19 with ``conf_mask``): alphas, the row sums cs and
    the betas or the island confidence."""
    A, B, steps, lens, a0, beta0, mask = _case(K, S, 10 * K + S)
    want = _jax_fb(A, B, steps, lens, a0, beta0, K, S, mask if conf else None)
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
    # Past each length the chains hold their carry.
    n = 5
    L = int(lens[0, n])
    assert np.array_equal(got[0][L:, :, n], np.broadcast_to(got[0][L - 1, :, n], (TP - L, K)))


@pytest.mark.parametrize("K,S", SHAPES)
def test_run_products_kernel_matches_jax(K, S):
    """B17 with PAD steps (the identity) and a PAD tail: each lane's product
    normalized to total 1 within rtol 1e-5 (the renormalization after every
    8th step is the same in both)."""
    A, B, steps, lens, _, _, _ = _case(K, S, 30 * K + S)
    rng = np.random.default_rng(K)
    sel_l = steps.T.copy()  # [NL, lane_T], the JAX layout
    sel_l[rng.random(sel_l.shape) < 0.1] = S
    sel_l[1, TP // 2 :] = S
    want = np.asarray(JFP._run_products_kernel(jnp.asarray(A), jnp.asarray(B),
                                               jnp.asarray(sel_l), TP, T_TILE, K, S))[:LANES]
    got = TFP._run_products_kernel(_t(A, False), _t(B, False),
                                   torch.from_numpy(np.ascontiguousarray(sel_l[:LANES].T)))
    got = got.numpy()
    assert got.shape == (LANES, K, K)
    norm = lambda x: x / x.sum(axis=(1, 2), keepdims=True)  # noqa: E731
    np.testing.assert_allclose(norm(got), norm(want), rtol=1e-5, atol=1e-7)
    # All-PAD lane: the identity, renormalized.
    allpad = torch.full((TP, 1), S, dtype=torch.int32)
    ident = TFP._run_products_kernel(_t(A, False), _t(B, False), allpad)[0]
    assert torch.equal(ident, torch.eye(K) / K)


def test_conf_path_from_streams_matches_jax(rng):
    """The want_path assembly: confidence within 1e-6, the MPM state equal
    (first maximum on exact ties, as ``jnp.argmax``)."""
    K, Tp, NL = 5, 40, 9
    al = rng.random((Tp, K, NL)).astype(np.float32)
    be = rng.random((Tp, K, NL)).astype(np.float32)
    be[3, :, 2] = 0.0  # an all-zero gamma: state 0
    al[6, 3, 4] = al[6, 1, 4] = 2.0  # an exact tie: the low state
    be[6, 3, 4] = be[6, 1, 4] = 3.0
    lens = rng.integers(0, Tp + 1, size=(1, NL)).astype(np.int32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    cj, pj = JFP._conf_path_from_streams(jnp.asarray(al), jnp.asarray(be), jnp.asarray(lens),
                                         jnp.asarray(mask))
    ct, pt = TFP._conf_path_from_streams(torch.from_numpy(al), torch.from_numpy(be),
                                         torch.from_numpy(lens), mask)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-7)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert pt.dtype == torch.int32 and int(pt[6, 4]) == 1 and int(pt[3, 2]) == 0


def test_conf_epilogue_equals_stream_assembly():
    """B19's epilogue (a product with the reciprocal) and the want_path
    assembly (a division) give the same confidence within 1 ulp-scale."""
    A, B, steps, lens, a0, beta0, mask = _case(8, 4, 5)
    args = (_t(A, False), _t(B, False), _t(steps), _t(lens), _t(a0), _t(beta0), T)
    alphas, _, betas = TFP._run_fb_kernels(*args)
    _, _, conf = TFP._run_fb_kernels(*args, conf_mask=mask)
    c2, _ = TFP._conf_path_from_streams(alphas, betas, _t(lens), mask)
    np.testing.assert_allclose(conf.numpy(), c2.numpy(), rtol=1e-6, atol=1e-7)


def test_emit_sel_and_step_table_match_jax(rng):
    K, S = 5, 3
    B = rng.dirichlet(np.ones(S), size=K).astype(np.float32)
    A = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    syms = rng.integers(0, S, size=17).astype(np.int32)
    want = np.asarray(JFP._emit_sel(jnp.asarray(B), jnp.asarray(syms), K, S))
    assert np.array_equal(TFP.emit_sel(torch.from_numpy(B), torch.from_numpy(syms)).numpy(),
                          want)
    tab = TFP.step_table(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert tab.shape == (S + 1, K * K)
    for s in range(S):
        assert np.array_equal(tab[s].reshape(K, K), A * B[:, s][None, :])
    assert np.array_equal(tab[S].reshape(K, K), np.eye(K, dtype=np.float32))


def test_supports():
    def model(K, S):
        return HmmParams.from_probs(np.full(K, 1 / K), np.full((K, K), 1 / K),
                                    np.full((K, S), 1 / S))

    assert TFP.supports(model(8, 4)) and TFP.supports(model(1, 16))
    assert not TFP.supports(model(9, 4)) and not TFP.supports(model(2, 17))
    assert TFP.MAX_STATES == 8
    with pytest.raises(ValueError, match="n_states <= 8"):
        TFP.tables(model(9, 4))


def _small_operands(K=3, S=4, Tp=16, NL=5):
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.dirichlet(np.ones(K), size=K).astype(np.float32))
    B = torch.from_numpy(rng.dirichlet(np.ones(S), size=K).astype(np.float32))
    steps = torch.from_numpy(rng.integers(0, S, size=(Tp, NL)).astype(np.int32))
    lens = torch.full((1, NL), Tp, dtype=torch.int32)
    vec = torch.ones((K, NL))
    cs = torch.ones((Tp, NL))
    streams = torch.ones((Tp, K, NL))
    mask = torch.ones(K)
    return dict(A=A, B=B, steps=steps, lens=lens, vec=vec, cs=cs, streams=streams, mask=mask)


def _call(name, o, **over):
    o = {**o, **over}
    if name == "fb_fwd":
        return TFP.fb_fwd(o["steps"], o["lens"], o["vec"], o["A"], o["B"])
    if name == "fb_bwd":
        return TFP.fb_bwd(o["steps"], o["lens"], o["cs"], o["vec"], o["A"], o["B"], 16)
    if name == "fb_bwd_conf":
        return TFP.fb_bwd_conf(o["steps"], o["lens"], o["cs"], o["vec"], o["streams"],
                               o["mask"], o["A"], o["B"], 16)
    if name == "fb_prod":
        return TFP.fb_prod(o["steps"], TFP.step_table(o["A"], o["B"]))
    return TFP.fb_stats(o["streams"], o["streams"], o["steps"], o["lens"], o["B"], 8)


@pytest.mark.parametrize("name", ["fb_fwd", "fb_bwd", "fb_bwd_conf", "fb_prod", "fb_stats"])
def test_wrappers_check_operands(name):
    """Each wrapper runs its plain version on CPU tensors and refuses a
    wrong dtype, a non-contiguous stream, a table too large for the
    kernels and a device that is neither the CPU nor a card."""
    o = _small_operands()
    out = _call(name, o)
    assert all(bool(torch.isfinite(x).all()) for x in (out if isinstance(out, tuple) else (out,)))
    with pytest.raises(ValueError):
        _call(name, o, steps=o["steps"].to(torch.int64))
    with pytest.raises(ValueError):
        _call(name, o, steps=torch.zeros((5, 16), dtype=torch.int32).T)
    with pytest.raises(ValueError):
        _call(name, o, B=torch.full((3, 17), 1 / 17))
    meta = {k: v.to("meta") for k, v in o.items()}
    with pytest.raises(ValueError, match="device"):
        _call(name, meta)
