"""The EM loop of the PyTorch port: the device loop (``fuse="auto"`` /
"on") against the host loop ("off"), on the CPU.

Both loops run the same float32 operations, so their results are equal
bit for bit — parameters, logliks, deltas, iteration counts and the
converged flag — for every backend, including a run that converges
early (the device loop has then run one E-step past convergence and
dropped it).  ``--em-fuse`` parses as the JAX CLI's flag does, and a
non-finite run raises FloatingPointError.
"""

import numpy as np
import pytest
import torch

from cpgisland_tpu_torch import cli as TCLI
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.train import backends as TBE
from cpgisland_tpu_torch.train import baum_welch as TBW
from cpgisland_tpu_torch.utils import chunking as TCH


def _chunked(seed=0, n=6000, chunk=2048):
    rng = np.random.default_rng(seed)
    return TCH.frame(rng.integers(0, 4, size=n).astype(np.uint8), chunk)


def _equal(a, b):
    same = all(torch.equal(x, y) for x, y in zip(
        (a.params.log_pi, a.params.log_A, a.params.log_B),
        (b.params.log_pi, b.params.log_A, b.params.log_B)))
    return (same and a.logliks == b.logliks and a.deltas == b.deltas
            and a.iterations == b.iterations and a.converged == b.converged)


# (label, model, backend factory, input)
RUNS = {
    "local": (presets.durbin_cpg8, lambda: "local", _chunked),
    "seq_reduced": (presets.durbin_cpg8, lambda: TBE.SeqBackend(lane_T=512), _chunked),
    "seq_one_pass": (presets.durbin_cpg8, lambda: TBE.SeqBackend(lane_T=512, one_pass=True),
                     _chunked),
    "seq_dense": (presets.two_state_cpg, lambda: TBE.SeqBackend(lane_T=512), _chunked),
    "seq2d": (presets.durbin_cpg8, lambda: TBE.Seq2DBackend(lane_T=256),
              lambda: TCH.bucket_records(
                  [np.random.default_rng(s).integers(0, 4, size=n).astype(np.uint8)
                   for s, n in ((1, 70_000), (2, 1500), (3, 1100))], floor=1024)),
}


@pytest.mark.parametrize("label", list(RUNS))
def test_device_loop_equals_host_loop(label):
    make, backend, data = RUNS[label]
    on = TBW.fit(make(), data(), num_iters=3, convergence=0.0, backend=backend(), fuse="on")
    off = TBW.fit(make(), data(), num_iters=3, convergence=0.0, backend=backend(), fuse="off")
    assert on.iterations == 3 and not on.converged
    assert _equal(on, off)
    assert set(on.phases) >= {"prepare", "estep", "mstep", "em"}


@pytest.mark.parametrize("label", ["local", "seq_reduced"])
def test_early_convergence_stops_both_loops_at_one_iteration(label):
    make, backend, data = RUNS[label]
    probe = TBW.fit(make(), data(), num_iters=6, convergence=0.0, backend=backend(), fuse="off")
    conv = float(np.median(probe.deltas))  # crossed partway through
    runs = [TBW.fit(make(), data(), num_iters=6, convergence=conv, backend=backend(), fuse=f)
            for f in ("auto", "off")]
    assert runs[0].converged and runs[0].iterations < 6
    assert all(_equal(runs[0], r) for r in runs[1:])


def test_device_loop_reads_nothing_per_iteration(monkeypatch):
    """The host loop's one blocking read an iteration is ``_fetch``; the
    device loop never calls it."""
    calls = []
    real = TBW._fetch
    monkeypatch.setattr(TBW, "_fetch", lambda x: calls.append(1) or real(x))
    TBW.fit(presets.durbin_cpg8(), _chunked(), num_iters=3, convergence=0.0, fuse="on")
    assert calls == []
    TBW.fit(presets.durbin_cpg8(), _chunked(), num_iters=3, convergence=0.0, fuse="off")
    assert len(calls) == 3


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_non_finite_run_raises(fuse):
    class Broken:
        """An E-step whose counts turn NaN at the second iteration."""

        def __init__(self):
            self.inner, self.calls = TBE.LocalBackend(), 0

        def prepare(self, chunked):
            return chunked

        def place(self, chunked, device):
            return self.inner.place(chunked, device)

        def prepare_streams(self, params, chunks, lengths):
            return self.inner.prepare_streams(params, chunks, lengths)

        def __call__(self, params, chunks, lengths, prepared=None):
            st = self.inner(params, chunks, lengths, prepared=prepared)
            self.calls += 1
            if self.calls >= 2:
                st = SuffStats(st.init, st.trans * float("nan"), st.emit,
                               st.loglik * float("nan"), st.n_seqs)
            return st

    with pytest.raises(FloatingPointError):
        TBW.fit(presets.durbin_cpg8(), _chunked(), num_iters=3, convergence=0.0,
                backend=Broken(), fuse=fuse)


def test_fuse_values():
    for bad in ("yes", 2, None):
        with pytest.raises(ValueError):
            TBW.fit(presets.durbin_cpg8(), _chunked(), num_iters=1, fuse=bad)
    assert TBW._parse_fuse("auto") and TBW._parse_fuse(True) and TBW._parse_fuse("on")
    assert not TBW._parse_fuse(False) and not TBW._parse_fuse("off")


def test_em_fuse_and_backend_flags_parse():
    p = TCLI.build_parser()
    for cmd in (["train", "x.fa", "--model-out", "m"], ["run", "a", "b", "--islands-out", "i",
                                                         "--model-out", "m"]):
        args = p.parse_args(cmd)
        assert (args.backend, args.em_fuse) == ("local", "auto")
        args = p.parse_args(cmd + ["--backend", "seq2d", "--em-fuse", "off"])
        assert (args.backend, args.em_fuse) == ("seq2d", "off")
        with pytest.raises(SystemExit):
            p.parse_args(cmd + ["--em-fuse", "sometimes"])
        with pytest.raises(SystemExit):
            p.parse_args(cmd + ["--backend", "pod"])


def test_positional_form_takes_backend_and_em_fuse(monkeypatch, tmp_path):
    seen = {}

    def fake_run(*a, **kw):
        seen.update(kw)
        return type("R", (), {"calls": []})()

    monkeypatch.setattr(TPL, "run", fake_run)
    argv = ["t.fa", "x.fa", str(tmp_path / "i"), str(tmp_path / "m"), "0.005", "3"]
    assert TCLI.main(argv + ["--backend", "seq", "--em-fuse=off", "--device", "cpu"]) == 0
    assert (seen["backend"], seen["fuse"], seen["device"]) == ("seq", "off", "cpu")
    assert TCLI.main(argv + ["--device", "cpu"]) == 0
    assert (seen["backend"], seen["fuse"]) == ("local", "auto")
    with pytest.raises(SystemExit):
        TCLI.main(argv + ["--backend", "pod", "--device", "cpu"])
