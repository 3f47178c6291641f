"""The port's native codec (``csrc/codec.cpp`` through ``utils/native.py``)
against the JAX package's codec and against the port's own NumPy path,
byte for byte, on the CPU.

The library builds with g++ into ``build/torch_native/`` at first use; a
failed build raises.  ``CPGISLAND_NATIVE=0`` selects the NumPy path, and
the dispatch tests hold the port to the JAX package's predicate: both
packages take the native path for the same file, size and policy.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu.utils import native as JN
from cpgisland_tpu_torch.utils import codec as TC
from cpgisland_tpu_torch.utils import native as TN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Adversarial FASTA files, each exercising one rule of the header state machine.
EDGE_CASES = {
    "crlf": b">chr1 desc\r\nACGT\r\nacgtNN\r\n>chr2\r\nGGCC\r\n",
    "mid_line_gt": b">h\nACG>TAC\nAC>\n>real\nTT\n",
    "header_at_eof": b">a\nACGT\n>tail header no newline",
    "lead_sequence": b"ACGTACGT\nGG\n>r1\nCCCC\n",
    "empty_records": b">e1\n>e2\n\n>e3\nACGT\n>e4\n",
    "iupac": b">iupac\nACGTRYKMSWBDHVN\nacgtrykmswbdhvn\n",
    "blank_lines": b"\n\n>b\n\nAC\n\n\nGT\n\n",
    "no_header": b"ACGTNNNNacgt\nTTTT",
    "only_header": b">just a header\n",
    "empty": b"",
    "gt_at_block_edge": b">" + b"x" * 30 + b"\n" + b"ACGT" * 20 + b"\n>" + b"y" * 7 + b"\nGG\n",
}


def _random_fasta(rng, n=60_000) -> bytes:
    """Headers, bases, IUPAC, mid-line '>', CR, blank lines and junk."""
    parts = []
    while sum(map(len, parts)) < n:
        kind = rng.integers(0, 6)
        if kind == 0:
            parts.append(rng.choice(list(b"ACGTacgtNnRY"), size=rng.integers(1, 200)).tobytes()
                         + b"\n")
        elif kind == 1:
            parts.append(b">chr" + bytes(rng.integers(48, 123, size=rng.integers(0, 30)).tolist())
                         + b"\n")
        elif kind == 2:
            parts.append(b"\n" * int(rng.integers(1, 3)))
        elif kind == 3:
            parts.append(bytes(rng.integers(0, 256, size=rng.integers(1, 40)).tolist()))
        elif kind == 4:
            parts.append(b"ACG>TAC\r\n")
        else:
            parts.append(b">long header " + b"acgt" * int(rng.integers(10, 300)) + b"\n")
    return b"".join(parts)


def _oracle(data: bytes) -> np.ndarray:
    return JC.encode_bytes(JC.strip_fasta_headers(data))


def _records(it):
    return [(n, np.asarray(s)) for n, s in it]


def _same_records(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype == np.uint8
        np.testing.assert_array_equal(x, y)


@pytest.fixture
def numpy_path(monkeypatch):
    """A context switch to the port's NumPy path (CPGISLAND_NATIVE=0)."""

    class Switch:
        def __enter__(self):
            monkeypatch.setenv("CPGISLAND_NATIVE", "0")

        def __exit__(self, *exc):
            monkeypatch.delenv("CPGISLAND_NATIVE", raising=False)

    return Switch()


def test_native_builds_and_is_selected():
    assert TN.available()
    assert TN.library_path().exists()
    assert TN.library_path().parent == TN.BUILD_DIR


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("read_size", [1, 3, 7, 1 << 24])
def test_edge_cases_equal_jax_and_numpy(case, read_size, tmp_path, numpy_path):
    data = EDGE_CASES[case]
    p = tmp_path / "e.fa"
    p.write_bytes(data)
    path = str(p)
    for skip in (True, False):
        want = np.concatenate(list(JC.iter_encoded_blocks(path, skip_headers=skip,
                                                          read_size=read_size)) or
                              [np.zeros(0, np.uint8)])
        got = np.concatenate(list(TC.iter_encoded_blocks(path, skip_headers=skip,
                                                         read_size=read_size)) or
                             [np.zeros(0, np.uint8)])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TC.encode_file(path, skip_headers=skip),
                                      JC.encode_file(path, skip_headers=skip))
    want_rec = _records(JC.iter_fasta_records(path, read_size=read_size))
    _same_records(_records(TC.iter_fasta_records(path, read_size=read_size)), want_rec)
    with numpy_path:
        assert not TN.available()
        _same_records(_records(TC.iter_fasta_records(path, read_size=read_size)), want_rec)
        np.testing.assert_array_equal(TC.encode_file(path, skip_headers=True), _oracle(data))


@pytest.mark.parametrize("read_size", [5, 64, 4096])
def test_random_files_across_block_boundaries(rng, read_size, tmp_path, numpy_path):
    data = _random_fasta(rng)
    p = tmp_path / "r.fa"
    p.write_bytes(data)
    path = str(p)
    got = np.concatenate(list(TC.iter_encoded_blocks(path, skip_headers=True,
                                                     read_size=read_size)))
    np.testing.assert_array_equal(got, _oracle(data))
    want = _records(JC.iter_fasta_records(path, read_size=read_size))
    _same_records(_records(TC.iter_fasta_records(path, read_size=read_size)), want)
    with numpy_path:
        _same_records(_records(TC.iter_fasta_records(path, read_size=read_size)), want)
        np.testing.assert_array_equal(
            np.concatenate(list(TC.iter_encoded_blocks(path, skip_headers=True,
                                                       read_size=read_size))), _oracle(data))


def test_fasta_encoder_random_pieces(rng):
    data = _random_fasta(rng, n=40_000)
    want = _oracle(data)
    for _ in range(5):
        cuts = np.sort(rng.integers(0, len(data), size=int(rng.integers(1, 400))))
        enc = TN.FastaEncoder()
        parts = [enc.feed(data[a:b]) for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(data)])]
        np.testing.assert_array_equal(np.concatenate(parts), want)
    np.testing.assert_array_equal(TN.encode(data), JC.encode_bytes(data))


def test_compact_copies_only_past_one_eighth_slack():
    out = np.arange(64, dtype=np.uint8)
    assert TN._compact(out, 60).base is out  # dense: a view
    short = TN._compact(out, 10)
    assert short.base is None and np.array_equal(short, out[:10])  # sparse: a copy
    data = b"N" * 1000 + b"AC"
    assert TN.encode(data).base is None  # a skip-dominated block holds no input-sized buffer


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_encode_mt_equals_jax_and_numpy(rng, threads):
    data = _random_fasta(rng, n=300_000)
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=True, threads=threads),
                                  _oracle(data))
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=False, threads=threads),
                                  TC.encode_bytes(data))
    arr = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(TN.encode_mt(arr, fasta=True, threads=threads),
                                  JN.encode_mt(arr, fasta=True, threads=threads))


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_encode_mt_multi_segment(threads):
    """Past the 4 MiB-a-thread floor several segments really run: segment
    offsets, skips beside the boundaries, headers in every segment."""
    data = (b"ACGT" * 1000 + b"NN\n") * 4200
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=False, threads=threads),
                                  JC.encode_bytes(data))
    fdata = (b">r fasta header line\n" + (b"acgtNRYK" * 1000 + b"\n") * 250) * 8
    np.testing.assert_array_equal(TN.encode_mt(fdata, fasta=True, threads=threads),
                                  _oracle(fdata))


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_encode_mt_giant_header_spans_segments(rng, threads):
    header = b">" + bytes(rng.choice(list(b"acgt ACGT_"), size=6 << 20).astype(np.uint8)) + b"\n"
    data = header + (b"ACGTacgt" * 1000 + b"\n") * 1200
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=True, threads=threads),
                                  _oracle(data))
    # A header that straddles a segment boundary at the nominal cut.
    cut = b"ACGT" * ((4 << 20) // 4 - 3) + b"\n"
    data = cut + b">straddling header acgt\n" + (b"GGCC" * 600 + b"\n") * 2000
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=True, threads=threads),
                                  _oracle(data))


def test_encode_mt_segment_slots(monkeypatch):
    """More threads than segment slots clamp to the slots; no slot at all is
    the C API's capacity sentinel, which raises."""
    data = (b"ACGT" * 1000 + b"\n") * 4200
    monkeypatch.setattr(TN, "MAX_SEGMENTS", 3)
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=True, threads=300),
                                  JC.encode_bytes(data))
    monkeypatch.setattr(TN, "MAX_SEGMENTS", 0)
    with pytest.raises(RuntimeError, match="more than 0 segments"):
        TN.encode_mt(data, fasta=True, threads=8)


def test_encode_mt_edge_cases():
    assert TN.encode_mt(b"", fasta=True).size == 0
    assert TN.encode_mt(b">only a header no newline", fasta=True).size == 0
    np.testing.assert_array_equal(TN.encode_mt(b">h\nACGT", fasta=True), [0, 1, 2, 3])
    data = b">h\nAC>GT\nacg"
    np.testing.assert_array_equal(TN.encode_mt(data, fasta=True), _oracle(data))


def test_native_disabled_selects_numpy(tmp_path, monkeypatch, rng):
    data = _random_fasta(rng, n=20_000)
    p = tmp_path / "d.fa"
    p.write_bytes(data)
    monkeypatch.setenv("CPGISLAND_NATIVE", "0")
    assert not TN.available() and TN.load() is None
    assert TN.encode(data) is None and TN.encode_mt(data) is None
    with pytest.raises(RuntimeError, match="CPGISLAND_NATIVE"):
        TN.FastaEncoder().feed(b"AC")
    monkeypatch.setattr(TC, "_MT_THRESHOLD", 1024)
    np.testing.assert_array_equal(TC.encode_file(str(p), skip_headers=True), _oracle(data))
    np.testing.assert_array_equal(TC.encode_file(str(p)), JC.encode_bytes(data))


def _spy(monkeypatch, module, names, calls, tag):
    for name in names:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append((tag, _name))
            return _real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("invalid", ["skip", "mask", "fail"])
def test_dispatch_matches_jax(big, skip, invalid, tmp_path, monkeypatch):
    """Both packages call the same native entries for the same file, size
    and policy: encode_mt past _MT_THRESHOLD under skip, the fused streaming
    kernel for clean blocks, the bulk kernel for header-free blocks."""
    data = b">r1 d\nACGTNNacgt\n" * 300 + b">r2\n" + b"GGCC\n" * 500
    p = tmp_path / "x.fa"
    if invalid == "fail":  # no invalid byte under the policy: headers are bytes in compat
        data = data.replace(b"N", b"A") if skip else b"ACGTacgt\n" * 1200
    p.write_bytes(data)
    path = str(p)
    threshold = 1024 if big else 1 << 30
    monkeypatch.setattr(TC, "_MT_THRESHOLD", threshold)
    monkeypatch.setattr(JC, "_MT_THRESHOLD", threshold)
    calls: list = []
    _spy(monkeypatch, TN, ("encode", "encode_mt"), calls, "port")
    _spy(monkeypatch, JN, ("encode", "encode_mt"), calls, "jax")
    fed = []
    for mod, tag in ((TN, "port"), (JN, "jax")):
        real_feed = mod.FastaEncoder.feed
        monkeypatch.setattr(mod.FastaEncoder, "feed",
                            lambda self, d, _r=real_feed, _t=tag: fed.append(_t) or _r(self, d))
    got = TC.encode_file(path, skip_headers=skip, invalid=invalid)
    want = JC.encode_file(path, skip_headers=skip, invalid=invalid)
    np.testing.assert_array_equal(got, want)
    _same_records(_records(TC.iter_fasta_records(path, read_size=64, invalid=invalid)),
                  _records(JC.iter_fasta_records(path, read_size=64, invalid=invalid)))
    port = sorted(n for t, n in calls if t == "port")
    jax_ = sorted(n for t, n in calls if t == "jax")
    assert port == jax_
    assert fed.count("port") == fed.count("jax")
    if invalid != "skip":
        assert not port and not fed


def test_failed_build_raises_with_the_compiler_report(tmp_path, monkeypatch):
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        TN.load()
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-built left in place
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        TN.load()


_BUILD_PROBE = r"""
import sys
from pathlib import Path
from cpgisland_tpu_torch.utils import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available()
import numpy as np
assert np.array_equal(native.encode_mt(b">h\nACGT\n", fasta=True), [0, 1, 2, 3])
print(native.library_path())
"""


def test_two_processes_build_at_once(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("CPGISLAND_NATIVE", None)
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE, str(build)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = sorted(x.name for x in build.iterdir())
    assert built == [os.path.basename(paths.pop())]  # one library, no temporary left
