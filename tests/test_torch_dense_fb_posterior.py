"""Soft decoding on the dense forward-backward engine end to end: the
PyTorch port's ``posterior_file``, ``batch_posterior`` and CLI
``posterior`` for the two_state preset vs the JAX package, on the CPU.

The port soft-decodes through the dense kernels' plain versions (B17,
B16, B18, or B19 without a path output); the JAX side through its dense
Pallas kernels in interpret mode (``engine="pallas"``) with the host
island caller.  Held: island files byte for byte, confidence within atol
2e-5 (the JAX package's own posterior pin).  Lanes are 1 Ki steps: the
plain chains are Python loops over the steps.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_pallas as JFP
from cpgisland_tpu_torch import cli
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq

from test_torch_dense_fb_pipeline import _seq, _write

SPAN = 1 << 13
T_TILE = 256


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A 12 kb record (two spans of SPAN) among records of 1.3-6 kb."""
    rng = np.random.default_rng(5)
    sizes = [2500, 12000, 5200, 1300, 6000]
    return _write(tmp_path_factory.mktemp("fa") / "g.fa",
                  [(f"rec{r}", _seq(rng, n)) for r, n in enumerate(sizes)])


@pytest.fixture(scope="module")
def jax_posterior(fasta, tmp_path_factory):
    """The JAX package's island file and confidence for the fixture."""
    want = io.StringIO()
    conf = tmp_path_factory.mktemp("jax") / "j.npy"
    JPL.posterior_file(fasta, JP.two_state_cpg(), islands_out=want, confidence_out=str(conf),
                       island_states=(0,), engine="pallas", island_engine="host")
    return want.getvalue(), np.load(conf)


@pytest.fixture
def short_lanes(monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)


def _two_state():
    jp = JP.two_state_cpg()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


@pytest.mark.parametrize("want_path", [False, True])
def test_dense_batch_posterior_matches_jax(rng, want_path):
    """two_state records one per lane (ragged, an empty one) vs
    ``batch_posterior_pallas(onehot=False)``."""
    jp, tp = _two_state()
    T = 1500
    chunks = np.stack([_seq(rng, T) for _ in range(6)]).astype(np.uint8)
    chunks[:, 300:1300] = rng.choice(4, size=(6, 1000), p=[0.14, 0.36, 0.36, 0.14])
    lengths = np.array([T, 700, 0, 1, T - 3, 300], np.int32)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    mask = np.array([1, 0], np.float32)
    c_j, p_j = JFP.batch_posterior_pallas(jp, jnp.asarray(chunks), jnp.asarray(lengths),
                                          jnp.asarray(mask), t_tile=T_TILE,
                                          want_path=want_path, onehot=False)
    c_t, p_t = fb_seq.batch_posterior(tp, torch.from_numpy(chunks), torch.from_numpy(lengths),
                                      mask, want_path=want_path, engine="pallas")
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=2e-5)
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert not c_t[2].any() and float(c_t.max()) > 0.5


@pytest.mark.parametrize("layout", ["batched", "per_record", "spans"])
def test_dense_posterior_file_matches_jax(fasta, jax_posterior, tmp_path, short_lanes,
                                         monkeypatch, layout):
    """two_state with island_states=(0,): records batched one per lane, each
    record in its own pass, and the 12 kb record as two threaded spans."""
    if layout == "per_record":
        monkeypatch.setattr(TPL, "POSTERIOR_BATCH_MAX", 1000)
    span = SPAN if layout == "spans" else TPL.POSTERIOR_SPAN
    want, cj = jax_posterior
    _, tp = _two_state()
    got = io.StringIO()
    res = TPL.posterior_file(fasta, tp, islands_out=got, confidence_out=str(tmp_path / "t.npy"),
                             island_states=(0,), span=span, device="cpu")
    assert got.getvalue() == want and want.count("\n") >= 3
    ct = np.load(tmp_path / "t.npy")
    assert ct.shape == cj.shape == (res.n_symbols,)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=2e-5)
    assert ("span-totals" in res.phases) == (layout == "spans")


def test_confidence_only_posterior_equals_path_run(fasta, tmp_path, short_lanes):
    """Without a path output the backward emits the confidence (B19's
    route): the same values as the path run's stream assembly, batched and
    span-threaded."""
    _, tp = _two_state()
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    TPL.posterior_file(fasta, tp, confidence_out=str(a), island_states=(0,), span=SPAN,
                       device="cpu")
    TPL.posterior_file(fasta, tp, confidence_out=str(b), mpm_path_out=str(tmp_path / "p.npy"),
                       island_states=(0,), span=SPAN, device="cpu")
    np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-6, atol=1e-7)


def test_cli_posterior_two_state(fasta, jax_posterior, tmp_path, short_lanes):
    """posterior --preset two_state --island-states 0: the JAX package's
    island file; two_state without --island-states is refused."""
    out = tmp_path / "i.txt"
    rc = cli.main(["posterior", fasta, "--preset", "two_state", "--island-states", "0",
                   "--islands-out", str(out), "--engine", "pallas", "--device", "cpu"])
    assert rc == 0
    assert out.read_text() == jax_posterior[0]
    with pytest.raises(SystemExit):
        cli.main(["posterior", fasta, "--preset", "two_state", "--islands-out", str(out),
                  "--device", "cpu"])
