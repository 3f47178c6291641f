"""``posterior_file`` with the device island engine against the host engine
and against the JAX package.

On the CPU the device engine (``ops.islands_device``) runs its plain torch
code where the MPM path lies, as it runs on the card.  The FASTA exercises
the three routes: one record alone, a small-record batch over two
power-of-two size classes (one island call per pass), and a record of three
threaded spans (its span paths joined before the call).  Island files are
held byte for byte: device engine = host engine = the JAX package's
(``engine="onehot"`` / ``"pallas"``, ``island_engine="host"``; its 8-device
CPU mesh has other lane geometries, and the fixture has no near-tie in the
MPM path).  An island-only device run sums the confidence on the device in
float32; its mean is held within 1e-6 relative of the host's float64 sum,
and a device run that writes the confidence writes the host run's bytes.
"""

import io

import numpy as np
import pytest

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu_torch import cli
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import fb_seq

SPAN = 1 << 15
# rec0 runs alone (flushed before the spanned record), rec1 runs three
# spans, rec2-rec4 batch in the 16 Ki and 32 Ki size classes.
SIZES = (2500, 70000, 5200, 1300, 20000)
MODELS = {  # name -> (JAX model, JAX engine, island_states)
    "durbin8": (JP.durbin_cpg8, "onehot", None),
    "two_state": (JP.two_state_cpg, "pallas", (0,)),
}


def _seq(rng, n):
    """Background at GC 0.41 with CpG depleted and GC-rich stretches."""
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    s[cg[rng.random(cg.size) < 0.75] + 1] = 0
    for a in range(400, n - 900, 5000):
        s[a : a + 800] = rng.choice(4, size=800, p=[0.15, 0.35, 0.35, 0.15])
    return s


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(23)
    path = tmp_path_factory.mktemp("fa") / "genome.fa"
    with open(path, "w") as f:
        for r, n in enumerate(SIZES):
            txt = "".join("ACGT"[x] for x in _seq(rng, n))
            f.write(f">rec{r} synthetic\n")
            for i in range(0, len(txt), 60):
                f.write(txt[i : i + 60] + "\n")
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def short_lanes():
    # Plain chains are Python loops over a lane's steps: keep lanes short.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
        yield


@pytest.fixture(scope="module")
def jax_islands(fasta):
    out = {}
    for name, (make, engine, states) in MODELS.items():
        buf = io.StringIO()
        JPL.posterior_file(fasta, make(), islands_out=buf, island_states=states, span=SPAN,
                           engine=engine, island_engine="host")
        out[name] = buf.getvalue()
    return out


def _port(fasta, name, tmp_path, **kw):
    make, _, states = MODELS[name]
    jp = make()
    tp = params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)
    buf = io.StringIO()
    res = TPL.posterior_file(fasta, tp, islands_out=buf, island_states=states, span=SPAN,
                             device="cpu", **kw)
    return buf.getvalue(), res


@pytest.mark.parametrize("name", list(MODELS))
def test_device_islands_match_host_and_jax(fasta, jax_islands, tmp_path, name):
    host, rh = _port(fasta, name, tmp_path, island_engine="host",
                     confidence_out=str(tmp_path / "h.npy"))
    dev, rd = _port(fasta, name, tmp_path, island_engine="device")
    dev_c, rdc = _port(fasta, name, tmp_path, island_engine="device",
                       confidence_out=str(tmp_path / "d.npy"))
    assert dev == host == dev_c == jax_islands[name] and host.count("\n") >= 3
    assert (tmp_path / "d.npy").read_bytes() == (tmp_path / "h.npy").read_bytes()
    assert rdc.mean_island_confidence == rh.mean_island_confidence
    # Island-only: the float32 device sum against the host's float64 sum.
    assert rd.mean_island_confidence == pytest.approx(rh.mean_island_confidence, rel=1e-6)
    assert set(rd.phases) == {"encode", "posterior", "span-totals", "islands"}


def test_device_islands_need_islands_out_without_path_dump(fasta, tmp_path):
    with pytest.raises(ValueError, match="needs islands_out and no mpm_path_out"):
        _port(fasta, "durbin8", tmp_path, island_engine="device",
              mpm_path_out=str(tmp_path / "p.npy"))
    # "auto" with a path dump calls islands on the host.
    got, _ = _port(fasta, "durbin8", tmp_path, island_engine="auto",
                   mpm_path_out=str(tmp_path / "p.npy"))
    assert np.load(tmp_path / "p.npy").shape == (sum(SIZES),) and got


def test_cli_island_cap_regrows(fasta, jax_islands, tmp_path, caplog):
    """``--island-cap 1`` overflows on every call; each overflow regrows the
    cap and re-runs only the calling pass, and the file is unchanged."""
    out = tmp_path / "islands.txt"
    rc = cli.main(["posterior", fasta, "--islands-out", str(out), "--island-engine", "device",
                   "--island-cap", "1", "--device", "cpu"])
    assert rc == 0 and out.read_text() == jax_islands["durbin8"]
    assert "overflowed cap=1" in caplog.text
    with pytest.raises(SystemExit):
        cli.main(["posterior", fasta, "--islands-out", str(out), "--island-cap", "0",
                  "--device", "cpu"])
