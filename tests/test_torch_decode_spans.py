"""``decode_file`` past the span: the port's span-wise clean decode and its
state-path dump against the JAX package's, and against the port's own
one-pass decode.

Records above ``SMALL_RECORD_MAX`` (lowered here on both sides, so that
records of a few thousand symbols take the single-record route) decode span
by span at ``span=4096``.  The JAX side runs its onehot XLA twins (the
dense "xla" ones for two_state) with the host island caller, on a
one-device mesh: the port's block geometry, so paths are equal bit for bit
and island files and int8 path dumps byte for byte.  The island files of
the port's host and device island engines are byte-identical too (the
device engine runs its plain torch code on the CPU).
"""

import io

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.parallel import decode as JD
from cpgisland_tpu.parallel.mesh import SEQ_AXIS
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy

SPAN = 4096
BOUNDARY_ISLAND = (SPAN - 400, SPAN + 500)  # 0-based [lo, hi) in rec0


def _seq(rng, n, gc):
    return rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """rec0: 3 spans and a ragged tail, a GC-rich island across the first
    span boundary; rec1: a small record (the flat batch); rec2: 2 spans and
    a tail, an N run (dropped by the skip policy) at its first span
    boundary; rec3, rec4: small."""
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("fa") / "genome.fa"
    recs = []
    s = _seq(rng, 3 * SPAN + 1234, 0.41)
    lo, hi = BOUNDARY_ISLAND
    s[lo:hi] = _seq(rng, hi - lo, 0.72)
    s[2 * SPAN - 300 : 2 * SPAN + 300] = _seq(rng, 600, 0.7)
    recs.append("".join("ACGT"[x] for x in s))
    recs.append("".join("ACGT"[x] for x in _seq(rng, 1800, 0.5)))
    t = "".join("ACGT"[x] for x in _seq(rng, 2 * SPAN + 100, 0.45))
    recs.append(t[: SPAN - 30] + "N" * 90 + t[SPAN + 60 :])
    recs += ["".join("ACGT"[x] for x in _seq(rng, n, 0.55)) for n in (700, 2500)]
    with open(path, "w") as f:
        for r, txt in enumerate(recs):
            f.write(f">rec{r} synthetic\n")
            for i in range(0, len(txt), 60):
                f.write(txt[i : i + 60] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def one_device_jax():
    """Both packages take records above 3000 symbols one at a time, and the
    JAX decode runs on a one-device mesh (the port's geometry)."""
    mesh1 = Mesh(np.array(jax.devices()[:1]), (SEQ_AXIS,))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "make_mesh", lambda *a, **k: mesh1)
        mp.setattr(JPL, "SMALL_RECORD_MAX", 3000)
        mp.setattr(TPL, "SMALL_RECORD_MAX", 3000)
        yield


def _both(jp):
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _jax_decode(fasta, jp, dump=None, **kw):
    buf = io.StringIO()
    JPL.decode_file(fasta, jp, islands_out=buf, compat=False, island_engine="host",
                    state_path_out=dump, **kw)
    return buf.getvalue()


def _port_decode(fasta, tp, **kw):
    buf = io.StringIO()
    res = TPL.decode_file(fasta, tp, islands_out=buf, compat=False, device="cpu", **kw)
    return buf.getvalue(), res


@pytest.fixture(scope="module")
def flagship(fasta, one_device_jax, tmp_path_factory):
    """The JAX span-wise decode and the port's one-pass decode of the
    flagship, each with its state-path dump."""
    jp, tp = _both(JP.durbin_cpg8())
    d = tmp_path_factory.mktemp("dumps")
    want = _jax_decode(fasta, jp, dump=str(d / "jax.npy"), span=SPAN, engine="onehot")
    one, res = _port_decode(fasta, tp, state_path_out=str(d / "one.npy"))
    return tp, want, one, res, (d / "jax.npy").read_bytes(), (d / "one.npy").read_bytes()


@pytest.mark.parametrize("island_engine", ["host", "device"])
def test_spanwise_islands_match_jax_and_one_pass(fasta, flagship, island_engine):
    tp, want, one, _, _, _ = flagship
    got, res = _port_decode(fasta, tp, span=SPAN, island_engine=island_engine)
    assert got == want == one and got
    # rec0 and rec2 ran 4 and 3 spans; rec1, rec3 and rec4 one each.
    assert res.n_chunks == 4 + 3 + 3
    # The island planted across the span boundary comes out whole.
    lo, hi = BOUNDARY_ISLAND
    rows = [ln.split() for ln in got.splitlines() if ln.startswith("rec0 ")]
    spans = [(int(r[1]), int(r[2])) for r in rows]
    assert any(b <= lo + 100 and e >= hi - 100 for b, e in spans), spans


@pytest.mark.parametrize("island_engine", ["host", "device"])
def test_spanwise_two_state_island_states(fasta, one_device_jax, island_engine):
    """two_state on the dense engine, islands from the observations."""
    jp, tp = _both(JP.two_state_cpg())
    want = _jax_decode(fasta, jp, span=SPAN, engine="xla", island_states=(0,))
    got, _ = _port_decode(fasta, tp, span=SPAN, island_states=(0,),
                          island_engine=island_engine)
    assert got == want and got


def test_state_path_dump_matches_jax(fasta, flagship, tmp_path):
    """The int8 dump, span-wise and one-pass, equals the JAX package's byte
    for byte; a dump forces the host island engine under "auto" and is
    refused with "device"."""
    tp, want, one, res1, jax_dump, one_dump = flagship
    got, res = _port_decode(fasta, tp, span=SPAN, state_path_out=str(tmp_path / "s.npy"),
                            island_engine="auto")
    assert got == want and (tmp_path / "s.npy").read_bytes() == jax_dump == one_dump
    dump = np.load(tmp_path / "s.npy")
    assert dump.dtype == np.int8 and dump.shape == (res.n_symbols,) == (res1.n_symbols,)
    with pytest.raises(ValueError, match="state-path dump"):
        TPL.decode_file(fasta, tp, compat=False, state_path_out=str(tmp_path / "x.npy"),
                        island_engine="device", device="cpu")
