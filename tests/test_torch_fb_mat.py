"""B8, the one-pass arm's matrix-carried chains, in the PyTorch port vs the
JAX package, on the CPU.

The port's wrapper ``fb_onehot.oh_fwdbwd_mat`` takes its plain version on
a CPU tensor; the JAX package's ``run_fb_mat_onehot`` runs its XLA twin
``_xla_fwdbwd_mat_onehot`` off the TPU.  Both carry the same f32
operations in the same order, but XLA:CPU contracts ``a*b + c*d`` into
fused multiply-adds, so the streams agree to a few ulps along the chains
(rtol 1e-5), not bit for bit (ROADMAP §C).  The lane totals of the
epilogue match B7's directions to ~ulp (rtol 1e-5).  The kernel itself is
held against the plain version bit for bit on the card (marker ``cuda``,
skipped here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.ops.prepared import prepare_seq
from cpgisland_tpu_torch.ops.viterbi_onehot import _groups

RTOL, ATOL = 1e-5, 1e-12

# (symbols, length, lane_T, lanes made empty): T not a multiple of lane_T,
# a ragged last lane, empty lanes.
GEOMETRIES = [(2900, 2711, 256, (3,)), (777, 500, 96, (0, 6))]


def _both():
    jp = JP.durbin_cpg8()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _streams(geom, seed=0):
    n, length, lane_T, empty = geom
    obs = np.random.default_rng(seed + n).integers(0, 4, size=n).astype(np.uint8)
    prep = prepare_seq(4, torch.from_numpy(obs), length, lane_T=lane_T)
    lens2 = prep.lane_lens[None, :].clone()
    for lane in empty:
        lens2[0, lane] = 0
    return prep, lens2.contiguous()


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda g: f"n{g[0]}-lt{g[2]}")
def case(request):
    """Both packages' B8 streams and epilogues on one geometry (the JAX
    side computed once per geometry)."""
    jp, tp = _both()
    prep, lens2 = _streams(request.param)
    lane_T = request.param[2]
    pair2, pairn2 = prep.pair2.numpy(), prep.pairn2.numpy()
    jva, jwb, jesym, jred = JFB.run_fb_mat_onehot(
        jp, jnp.asarray(lens2.numpy()), 8, lane_T,
        (jnp.asarray(pair2), None, jnp.asarray(pairn2)))
    tva, twb, tesym, tred = TFB.run_fb_mat_onehot(tp, lens2, lane_T,
                                                  (prep.pair2, None, prep.pairn2))
    return dict(jp=jp, tp=tp, prep=prep, lens2=lens2, lane_T=lane_T,
                j=(np.asarray(jva), np.asarray(jwb), np.asarray(jesym), np.asarray(jred)),
                t=(tva, twb, tesym, tred))


def test_plain_matches_xla_twin(case):
    jva, jwb, jesym, _ = case["j"]
    tva, twb, tesym, _ = case["t"]
    assert tva.shape == jva.shape and twb.shape == jwb.shape
    np.testing.assert_allclose(tva.numpy(), jva, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(twb.numpy(), jwb, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tesym.numpy(), jesym)


def test_plain_matches_twin_called_directly(case):
    """The wrapper's plain version against the twin on the same clamped
    inputs, without the runners around them."""
    jp, tp, prep, lens2, lane_T = (case[k] for k in ("jp", "tp", "prep", "lens2", "lane_T"))
    jtab = jnp.concatenate([JFB.prob_pair_table(jp, JFB._groups(jp)),
                            jnp.asarray([JFB.PROB_IDENT], jnp.float32)], axis=0)
    clamp = lambda x: jnp.minimum(jnp.asarray(x.numpy()), 16)
    jva, jwb = JFB._xla_fwdbwd_mat_onehot(jtab, clamp(prep.pair2), clamp(prep.pairn2),
                                          jnp.asarray(lens2.numpy()), lane_T)
    tab = TFB.prob_tab_ext(tp, _groups(tp))
    tva, twb = TFB.oh_fwdbwd_mat(prep.pair2, prep.pairn2, lens2, tab, lane_T)
    np.testing.assert_allclose(tva.numpy(), np.asarray(jva), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(twb.numpy(), np.asarray(jwb), rtol=RTOL, atol=ATOL)


def test_lane_totals_match_jax_and_products(case):
    """red from the epilogue against the JAX package's and against B7's
    lane products (the two-pass arm's input to the same boundary glue)."""
    _, _, _, jred = case["j"]
    tred = case["t"][3]
    np.testing.assert_allclose(tred.numpy(), jred, rtol=RTOL, atol=ATOL)
    # B7 reads the pair stream only; the lanes this case empties by length
    # keep their pairs, so they are left out of this comparison.
    prod = TFB.products_reduced(case["tp"], case["prep"].pair2)
    keep = (case["lens2"][0] == case["prep"].lane_lens).numpy()
    np.testing.assert_allclose(tred.numpy()[keep], prod.numpy()[keep], rtol=RTOL, atol=ATOL)


def test_contract_and_loglik_match_jax(case):
    jva, jwb, jesym, _ = case["j"]
    tva, twb, tesym, _ = case["t"]
    K, NL = 8, tva.shape[2]
    rng = np.random.default_rng(NL)
    a0 = (rng.random((K, NL)) + 0.05).astype(np.float32)
    b0 = (rng.random((K, NL)) + 0.05).astype(np.float32)
    jgt = JFB._groups(case["jp"])
    jal, jbe = JFB.contract_mat_streams(jnp.asarray(jva), jnp.asarray(jwb), jnp.asarray(a0),
                                        jnp.asarray(b0), jgt, jnp.asarray(jesym))
    tal, tbe = TFB.contract_mat_streams(tva, twb, torch.from_numpy(a0), torch.from_numpy(b0),
                                        _groups(case["tp"]), tesym)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tbe.numpy(), np.asarray(jbe), rtol=RTOL, atol=ATOL)
    lens2 = case["lens2"]
    jll = JFB.mat_loglik_lanes(jnp.asarray(jva), jal, jnp.asarray(lens2.numpy()))
    tll = TFB.mat_loglik_lanes(tva, tal, lens2)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=RTOL, atol=1e-3)
    assert np.all(tll.numpy()[lens2.numpy() == 0] == 0.0)


def _args():
    _, tp = _both()
    prep, lens2 = _streams(GEOMETRIES[0])
    return [prep.pair2, prep.pairn2, lens2, TFB.prob_tab_ext(tp, _groups(tp)), GEOMETRIES[0][2]]


@pytest.mark.parametrize("slot,bad", [
    (0, lambda t: t.long()),                     # pairs must be int32
    (1, lambda t: t[:-1].contiguous()),          # pairn2's shape must match pair2's
    (2, lambda t: t[0]),                         # lens2 must be [1, NL]
    (3, lambda t: t.double()),                   # the table must be f32
    (3, lambda t: torch.zeros((300, 4))),        # at most 16 symbols
    (0, lambda t: t.T),                          # operands must be contiguous
    (3, lambda t: t.to("meta")),                 # one device for every operand
])
def test_wrapper_refuses_bad_operands(slot, bad):
    args = _args()
    args[slot] = bad(args[slot])
    with pytest.raises(ValueError):
        TFB.oh_fwdbwd_mat(*args)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _args()
    va, wb = TFB.oh_fwdbwd_mat(*args)
    pva, pwb = TFB.oh_fwdbwd_mat_plain(*args)
    assert torch.equal(va, pva) and torch.equal(wb, pwb)


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the B8 kernel has no CPU mode")
    from cpgisland_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    for geom in GEOMETRIES:
        prep, lens2 = _streams(geom)
        _, tp = _both()
        tab = TFB.prob_tab_ext(tp.to(dev), _groups(tp.to(dev)))
        args = (prep.pair2.to(dev), prep.pairn2.to(dev), lens2.to(dev), tab, geom[2])
        before = _kernels.launches["oh_fwdbwd_mat"]
        got = TFB.oh_fwdbwd_mat(*args)
        want = TFB.oh_fwdbwd_mat_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert _kernels.launches["oh_fwdbwd_mat"] == before + 1
