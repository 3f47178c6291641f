"""End to end through the dense engines: the port's ``decode_file`` and CLI
write island files byte-identical to the JAX package's ``decode_file`` on
the CPU for the two_state preset (observation-based calls), for the
flagship on records that open with N under ``invalid_symbols="mask"`` (the
pad-first demotion), and for an 8-state model whose emissions are not
one-hot pairs, in compat and clean mode.

On the CPU the JAX package's 'auto' engine is its xla twin, sharded over
the 8-device virtual mesh for whole records; the port decodes with the
dense kernels' plain versions over one device.  Batched records decode bit
for bit alike; whole records differ in block geometry, so their paths could
differ only at float32 near-ties, which these fixtures do not contain.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.models.hmm import HmmParams as JHmm
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models.hmm import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain dense batch walks 4096 steps of ops over 128 lanes (8
    rows of a 64 Ki pad, 16 blocks each), past PyTorch's intra-op grain:
    every step then forks its thread pool, which under a parallel test run
    (several workers on the same cores) cost 60x.  One thread keeps each
    step's op inline."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n, gc):
    return rng.choice(4, size=n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])


def _write(path, records):
    with open(path, "w") as f:
        for name, txt in records:
            f.write(f">{name} synthetic\n")
            for i in range(0, len(txt), 60):
                line = txt[i : i + 60]
                f.write((line.lower() if (i // 60) % 7 == 3 else line) + "\n")
    return str(path)


def _record(rng, n, lead_n=0):
    s = _seq(rng, n, 0.41)
    for a in (n // 5, (3 * n) // 5):
        s[a : a + 900] = _seq(rng, 900, 0.7)
    txt = "".join("ACGT"[x] for x in s)
    return "N" * lead_n + txt[:300] + "NNNNNNNN" + txt[300:]


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Five records of background with planted GC-rich segments; the
    second and fourth open with an N run."""
    rng = np.random.default_rng(21)
    recs = [(f"rec{r}", _record(rng, int(rng.integers(4000, 9000)), (0, 500, 0, 40, 0)[r]))
            for r in range(5)]
    return _write(tmp_path_factory.mktemp("fa") / "genome.fa", recs)


def _dense8_probs(rng):
    """8 states, 4 symbols, each state emitting two bases (not one-hot)."""
    pi = rng.dirichlet(np.ones(8))
    A = 0.02 * rng.dirichlet(np.ones(8), size=8)
    A[:4, :4] += 0.98 * rng.dirichlet(np.ones(4) * 4, size=4)
    A[4:, 4:] += 0.98 * rng.dirichlet(np.ones(4) * 4, size=4)
    B = np.zeros((8, 4))
    for k in range(8):
        B[k, k % 4] = 0.9
        B[k, (k + 1) % 4] = 0.1
    return pi, A, B


def _pair(name):
    jp = {
        "two_state": JP.two_state_cpg,
        "durbin8": JP.durbin_cpg8,
        "dense8": lambda: JHmm.from_probs(*_dense8_probs(np.random.default_rng(8))),
    }[name]()
    return jp, params_from_numpy(jp.log_pi, jp.log_A, jp.log_B)


def _decode_both(path, model, monkeypatch=None, small_max=None, jax_kw=None, **kw):
    if small_max is not None:
        monkeypatch.setattr(JPL, "SMALL_RECORD_MAX", small_max)
        monkeypatch.setattr(TPL, "SMALL_RECORD_MAX", small_max)
    jp, tp = _pair(model)
    want, got = io.StringIO(), io.StringIO()
    rj = JPL.decode_file(path, jp, islands_out=want, island_engine="host",
                         **(jax_kw or {}), **kw)
    rt = TPL.decode_file(path, tp, islands_out=got, device="cpu", **kw)
    assert (rt.n_symbols, rt.n_chunks) == (rj.n_symbols, rj.n_chunks)
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("small_max", [4 << 20, 2000])
def test_two_state_clean_matches_jax(fasta, monkeypatch, small_max):
    """(a) two_state with island_states=(0,): the dense batch (small_max =
    4 Mi) and the whole-record route (small_max = 2000)."""
    want, got = _decode_both(fasta, "two_state", monkeypatch, small_max, compat=False,
                             island_states=(0,), min_len=50)
    assert got == want and got.count("\n") >= 3


@pytest.mark.parametrize("lead_n", [1, 3000])
def test_pad_first_flagship_matches_jax(tmp_path, lead_n):
    """(b) One record of a few tens of kilobases that opens with an N run,
    under mask: the flagship's reduced engine hands it to the dense
    kernels, as the JAX package demotes it."""
    rng = np.random.default_rng(lead_n)
    fa = _write(tmp_path / "padfirst.fa", [("chr", _record(rng, 30_000, lead_n))])
    want, got = _decode_both(fa, "durbin8", compat=False, invalid_symbols="mask")
    assert got == want and got.count("\n") >= 2


@pytest.mark.parametrize("compat", [True, False])
def test_non_onehot_model_matches_jax(fasta, compat):
    """(c) An 8-state model outside the reduced domain: the dense batch of
    4 Ki chunks (compat) and of records (clean)."""
    want, got = _decode_both(fasta, "dense8", compat=compat, chunk_size=4096)
    assert got == want and got


@pytest.mark.parametrize("model,kw", [
    ("two_state", {"island_states": (0,)}),
    ("durbin8", {"invalid_symbols": "mask"}),
    ("dense8", {}),
])
@pytest.mark.parametrize("small_max", [4 << 20, 2000])
def test_host_and_device_island_engines_agree(fasta, monkeypatch, model, kw, small_max):
    """(d) island_engine 'device' (the torch caller, here on the CPU) and
    'host' give identical files, batched and per record."""
    monkeypatch.setattr(TPL, "SMALL_RECORD_MAX", small_max)
    _, tp = _pair(model)
    outs = []
    for eng in ("host", "device"):
        buf = io.StringIO()
        res = TPL.decode_file(fasta, tp, islands_out=buf, compat=False, island_engine=eng,
                              device="cpu", **kw)
        outs.append(buf.getvalue())
        assert set(res.phases) == {"encode", "decode", "islands"}
    assert outs[0] == outs[1] and outs[0]


def test_pad_first_small_batch_matches_jax_flat_onehot(tmp_path):
    """Small records that open with N, batched under mask, stay on the flat
    onehot batch (the JAX package does not demote them there either): the
    port matches the JAX package's engine='onehot' byte for byte."""
    rng = np.random.default_rng(5)
    recs = [(f"s{r}", _record(rng, int(rng.integers(3000, 6000)), lead)) for r, lead in
            enumerate((200, 0, 1, 700, 50))]
    fa = _write(tmp_path / "scaffolds.fa", recs)
    want, got = _decode_both(fa, "durbin8", compat=False, invalid_symbols="mask",
                             jax_kw={"engine": "onehot"})
    assert got == want and got.count("\n") >= 3


def test_island_engine_rules(fasta):
    _, tp = _pair("durbin8")
    _, ts = _pair("two_state")
    with pytest.raises(ValueError, match="clean"):
        TPL.decode_file(fasta, tp, compat=True, island_engine="device", device="cpu")
    with pytest.raises(ValueError, match="island_engine"):
        TPL.decode_file(fasta, tp, compat=False, island_engine="gpu", device="cpu")
    with pytest.raises(ValueError, match="island_states"):
        TPL.decode_file(fasta, ts, compat=False, device="cpu")
    with pytest.raises(ValueError, match="clean mode"):
        TPL.decode_file(fasta, ts, compat=True, island_states=(0,), device="cpu")
    assert TPL.island_layout_error(ts, (0,)) is None and TPL.island_layout_error(tp) is None
    use, box = TPL._resolve_island_engine("auto", dev=TPL.resolve_device("cpu"),
                                          device_eligible=True, ineligible_msg="",
                                          island_cap=None)
    assert not use and box == [1 << 17]  # auto calls on the host without a card


def _run(cmd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_two_state_matches_jax(fasta, tmp_path):
    """python -m cpgisland_tpu_torch decode --clean --preset two_state
    --island-states 0 == python -m cpgisland_tpu with the same arguments,
    each with its own preset."""
    args = ["decode", fasta, "--clean", "--preset", "two_state", "--island-states", "0",
            "--min-len", "50"]
    ours, theirs = tmp_path / "t.txt", tmp_path / "j.txt"
    pt = _run(["cpgisland_tpu_torch", *args, "--islands-out", str(ours), "--device", "cpu"])
    pj = _run(["cpgisland_tpu", "--platform", "cpu", *args, "--islands-out", str(theirs)])
    assert pt.returncode == 0 and pj.returncode == 0, pt.stderr + pj.stderr
    assert ours.read_text() == theirs.read_text() and ours.read_text()
    bad = _run(["cpgisland_tpu_torch", "decode", fasta, "--clean", "--preset", "two_state",
                "--islands-out", str(ours), "--device", "cpu"])
    assert bad.returncode == 2 and "island_states" in bad.stderr


def test_cli_mask_decodes_a_pad_first_record(tmp_path):
    fa = _write(tmp_path / "n.fa", [("chr", _record(np.random.default_rng(3), 20_000, 1000))])
    out = tmp_path / "i.txt"
    p = _run(["cpgisland_tpu_torch", "decode", fa, "--clean", "--invalid-symbols", "mask",
              "--island-engine", "device", "--islands-out", str(out), "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    want = io.StringIO()
    JPL.decode_file(fa, JP.durbin_cpg8(), islands_out=want, compat=False,
                    invalid_symbols="mask", island_engine="host")
    assert out.read_text() == want.getvalue() and want.getvalue()
