"""Symbol caches in the port vs the JAX package, on the CPU.

A cache is a file's clean (FASTA-aware, skip) encode stored once: a
streamed ``.symbols.npy`` and a ``.meta.npz`` of the record names, offsets
and the source's size and mtime_ns.  The port writes the JAX package's
format, so a cache written by either package is valid for the other: the
symbols file byte for byte, the metadata array for array (a zip archive's
member timestamps differ).  A hit is a read-only memmap: the pipelines run
on it with warnings turned into errors, which catches any tensor that
would alias the read-only mapping (and a guard on ``torch.from_numpy`` /
``torch.as_tensor`` checks every call), and their island and report files
equal the JAX package's (models within the EM parity bound, and each
cached run's files equal the uncached run's byte for byte).
"""

import io
import os
import warnings

import numpy as np
import pytest
import torch

from cpgisland_tpu import family as JFAM
from cpgisland_tpu import pipeline as JPL
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.serve.session import Session
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu_torch import cli as TCLI
from cpgisland_tpu_torch import family as TFAM
from cpgisland_tpu_torch import pipeline as TPL
from cpgisland_tpu_torch.models import presets as TP
from cpgisland_tpu_torch.models.hmm import load_text
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.utils import codec as TC

CHUNK = 4096


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n):
    s = rng.choice(4, size=n, p=[0.295, 0.205, 0.205, 0.295])
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    s[cg[rng.random(cg.size) < 0.75] + 1] = 0
    for a in range(300, n - 900, 3000):
        s[a : a + 700] = rng.choice(4, size=700, p=[0.15, 0.35, 0.35, 0.15])
    return s


@pytest.fixture
def fasta(tmp_path):
    """Three records, N runs, soft-masked lines, a mid-line '>'."""
    rng = np.random.default_rng(31)
    path = tmp_path / "g.fa"
    with open(path, "w") as f:
        for i, n in enumerate((7000, 2500, 5200)):
            txt = "".join("ACGT"[x] for x in _seq(rng, n))
            txt = txt[:500] + "NNNNNNNNNN" + txt[500:]
            lines = [txt[j : j + 60] for j in range(0, len(txt), 60)]
            lines[3] = lines[3].lower()
            f.write(f">rec{i} synthetic record\n" + "\n".join(lines) + "\n")
        f.write(">tail\nACGT>ACGT\n")
    return str(path)


def _meta(prefix):
    m = np.load(prefix + ".meta.npz", allow_pickle=True)
    return {k: m[k] for k in m.files}


def test_the_cache_is_the_jax_cache(fasta, tmp_path):
    tp, jp = str(tmp_path / "port"), str(tmp_path / "jax")
    assert TC.write_symbol_cache(fasta, tp) == JC.write_symbol_cache(fasta, jp)
    assert TC.symbol_cache_paths(tp) == (tp + ".symbols.npy", tp + ".meta.npz")
    with open(tp + ".symbols.npy", "rb") as a, open(jp + ".symbols.npy", "rb") as b:
        assert a.read() == b.read()
    mt, mj = _meta(tp), _meta(jp)
    assert sorted(mt) == sorted(mj) == ["mtime_ns", "names", "offsets", "size", "version"]
    for k in mt:
        assert mt[k].dtype == mj[k].dtype, k
        np.testing.assert_array_equal(mt[k], mj[k])
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]  # temporaries renamed away


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_cache(fasta, tmp_path, writer):
    prefix = str(tmp_path / "c")
    (TC if writer == "port" else JC).write_symbol_cache(fasta, prefix)
    t_hit, j_hit = TC.open_symbol_cache(fasta, prefix), JC.open_symbol_cache(fasta, prefix)
    assert t_hit is not None and j_hit is not None
    assert t_hit[0] == j_hit[0]
    np.testing.assert_array_equal(t_hit[1], j_hit[1])
    np.testing.assert_array_equal(t_hit[2], j_hit[2])
    assert not t_hit[2].flags.writeable
    want = list(JC.iter_fasta_records(fasta))
    got = list(TC.iter_fasta_records_cached(fasta, prefix))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TC.encode_file_cached(fasta, prefix, skip_headers=True),
                                  JC.encode_file(fasta, skip_headers=True))


@pytest.mark.parametrize("change", ["size", "mtime"])
def test_cache_goes_stale(fasta, tmp_path, change):
    prefix = str(tmp_path / "c")
    TC.write_symbol_cache(fasta, prefix)
    st = os.stat(fasta)
    if change == "size":
        with open(fasta, "a") as f:
            f.write(">extra\nGGGG\n")
        os.utime(fasta, ns=(st.st_atime_ns, st.st_mtime_ns))
    else:
        os.utime(fasta, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert TC.open_symbol_cache(fasta, prefix) is None
    assert JC.open_symbol_cache(fasta, prefix) is None
    # A read through the cache rebuilds it for the new file.
    got = [n for n, _ in TC.iter_fasta_records_cached(fasta, prefix)]
    assert got == [n for n, _ in JC.iter_fasta_records(fasta)]
    assert TC.open_symbol_cache(fasta, prefix) is not None


def test_a_hit_parses_nothing(fasta, tmp_path, monkeypatch):
    prefix = str(tmp_path / "c")
    want = list(TC.iter_fasta_records_cached(fasta, prefix))  # the miss builds it
    whole = TC.encode_file_cached(fasta, prefix, skip_headers=True)

    def no_parse(*a, **k):
        raise AssertionError("a cache hit parsed the FASTA")

    for name in ("iter_fasta_records", "encode_file", "iter_encoded_blocks"):
        monkeypatch.setattr(TC, name, no_parse)
    got = list(TC.iter_fasta_records_cached(fasta, prefix))
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_array_equal(TC.encode_file_cached(fasta, prefix, skip_headers=True), whole)


@pytest.mark.parametrize("policy", ["mask", "fail"])
def test_mask_and_fail_bypass_the_cache(fasta, tmp_path, policy):
    prefix = str(tmp_path / "c")
    if policy == "fail":
        with pytest.raises(TC.InvalidSymbolError):
            list(TC.iter_fasta_records_cached(fasta, prefix, invalid=policy))
        with pytest.raises(TC.InvalidSymbolError):
            TC.encode_file_cached(fasta, prefix, skip_headers=True, invalid=policy)
    else:
        got = list(TC.iter_fasta_records_cached(fasta, prefix, invalid=policy))
        want = list(JC.iter_fasta_records(fasta, invalid=policy))
        for (a, x), (b, y) in zip(got, want):
            assert a == b
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            TC.encode_file_cached(fasta, prefix, skip_headers=True, invalid=policy),
            JC.encode_file(fasta, skip_headers=True, invalid=policy))
    assert not os.path.exists(prefix + ".symbols.npy")  # nothing written
    with pytest.raises(ValueError):
        TC.encode_file_cached(fasta, prefix, skip_headers=True, invalid="drop")


def test_compat_mode_raises(fasta, tmp_path):
    prefix = str(tmp_path / "c")
    params = TP.durbin_cpg8()
    with pytest.raises(ValueError, match="FASTA-aware"):
        TPL.decode_file(fasta, params, compat=True, symbol_cache=prefix, device="cpu")
    with pytest.raises(ValueError, match="FASTA-aware"):
        TPL.train_file(fasta, compat=True, symbol_cache=prefix, device="cpu")
    with pytest.raises(ValueError, match="FASTA-aware"):
        TPL.run(fasta, fasta, str(tmp_path / "i"), str(tmp_path / "m"), compat=True,
                symbol_cache=prefix, device="cpu")
    # The compat encode itself never reads a cache.
    np.testing.assert_array_equal(TC.encode_file_cached(fasta, prefix, skip_headers=False),
                                  JC.encode_file(fasta, skip_headers=False))
    assert not os.path.exists(prefix + ".meta.npz")
    with pytest.raises(SystemExit):
        TCLI.main(["decode", fasta, "--islands-out", str(tmp_path / "i"),
                   "--symbol-cache", prefix, "--device", "cpu"])


@pytest.mark.parametrize("form", ["array", "read_only", "memmap", "tensor"])
def test_upload_never_aliases_a_read_only_array(tmp_path, form):
    """``chunking.upload``, the one way symbols become tensors: a writeable
    array is shared, a read-only one (a cache hit's memmap slice) copied, a
    tensor moved as it is; the values and dtype are the source's."""
    from cpgisland_tpu_torch.utils import chunking as TCH

    arr = np.arange(40, dtype=np.uint8) % 5
    if form == "read_only":
        src = arr.copy()
        src.flags.writeable = False
    elif form == "memmap":
        np.save(tmp_path / "s.npy", arr)
        src = np.load(tmp_path / "s.npy", mmap_mode="r")[3:]
        arr = arr[3:]
    else:
        src = torch.from_numpy(arr.copy()) if form == "tensor" else arr.copy()
    got = _strict(TCH.upload, src, "cpu")
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), arr)
    if form == "tensor":
        assert got is src
    elif form == "array":
        assert np.shares_memory(got.numpy(), src)
    else:
        assert not np.shares_memory(got.numpy(), src)
        got[0] = 9  # writing the copy leaves the read-only source as it was
        assert int(src[0]) == int(arr[0])


def _read_only_guard(real):
    def guarded(x, *a, **k):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            raise AssertionError("a tensor would alias a read-only array (a cache memmap)")
        return real(x, *a, **k)

    return guarded


def _strict(fn, *a, **k):
    """Run ``fn`` with every warning an error and with torch.from_numpy /
    torch.as_tensor refusing a read-only array: torch warns only once a
    process when a tensor aliases one, so the guard checks every call."""
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("error")
        mp.setattr(torch, "from_numpy", _read_only_guard(torch.from_numpy))
        mp.setattr(torch, "as_tensor", _read_only_guard(torch.as_tensor))
        return fn(*a, **k)


def _twice(fn, prefix):
    """(miss, hit) outputs of ``fn(prefix)``: the first call builds the
    cache, the second reads it."""
    assert TC.open_symbol_cache.__module__  # the port's codec
    miss = fn(prefix)
    assert os.path.exists(prefix + ".symbols.npy")
    hit = _strict(fn, prefix)
    return miss, hit


@pytest.mark.parametrize("island_engine", ["host", "device"])
def test_decode_file_with_a_cache_equals_jax(fasta, tmp_path, monkeypatch, island_engine):
    """Records above SMALL_RECORD_MAX (lowered here) decode one by one from
    the memmap slice itself, as a genome's chromosomes do."""
    monkeypatch.setattr(TPL, "SMALL_RECORD_MAX", 3000)
    jp, tp = JP.two_state_cpg(), TP.two_state_cpg()

    def port(prefix):
        buf = io.StringIO()
        TPL.decode_file(fasta, tp, islands_out=buf, compat=False, island_states=(0,),
                        symbol_cache=prefix, island_engine=island_engine, device="cpu")
        return buf.getvalue()

    miss, hit = _twice(port, str(tmp_path / "c"))
    want = io.StringIO()
    JPL.decode_file(fasta, jp, islands_out=want, compat=False, island_states=(0,),
                    symbol_cache=str(tmp_path / "j"), island_engine="host")
    assert miss == hit == want.getvalue() == port(None) and hit
    # The flagship, through the cache the JAX package wrote.
    got = io.StringIO()
    _strict(TPL.decode_file, fasta, TP.durbin_cpg8(), islands_out=got, compat=False,
            symbol_cache=str(tmp_path / "j"), device="cpu")
    want = io.StringIO()
    JPL.decode_file(fasta, JP.durbin_cpg8(), islands_out=want, compat=False, engine="onehot",
                    island_engine="host")
    assert got.getvalue() == want.getvalue()


def _same_dump(port_text, jax_path):
    from cpgisland_tpu.models import hmm as JH

    j = JH.load_text(jax_path)
    t = load_text(io.StringIO(port_text))
    for a, b in zip((t.pi, t.A, t.B), (j.pi, j.A, j.B)):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(a, b, atol=1e-5)
        assert np.array_equal(a == 0, b == 0)


@pytest.mark.parametrize("backend", ["local", "seq", "seq2d"])
def test_train_file_with_a_cache_equals_jax(fasta, tmp_path, backend, monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)

    def port(prefix):
        out = tmp_path / "t.txt"
        TPL.train_file(fasta, compat=False, num_iters=2, convergence=0.0, chunk_size=CHUNK,
                       backend=backend, symbol_cache=prefix, model_out=str(out), device="cpu")
        return out.read_text()

    miss, hit = _twice(port, str(tmp_path / "c"))
    assert miss == hit == port(None)
    if backend == "local":
        jm = str(tmp_path / "j.txt")
        JPL.train_file(fasta, compat=False, num_iters=2, convergence=0.0, chunk_size=CHUNK,
                       engine="onehot", symbol_cache=str(tmp_path / "j"), model_out=jm)
        _same_dump(hit, jm)


def test_posterior_file_with_a_cache_equals_jax(fasta, tmp_path, monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    monkeypatch.setattr(TPL, "POSTERIOR_BATCH_MAX", 3000)  # records one by one, from the memmap
    jp, tp = JP.durbin_cpg8(), TP.durbin_cpg8()

    def port(prefix):
        buf = io.StringIO()
        conf = str(tmp_path / "conf.npy")
        TPL.posterior_file(fasta, tp, islands_out=buf, confidence_out=conf,
                           symbol_cache=prefix, device="cpu")
        return buf.getvalue(), np.load(conf)

    (m_isl, m_conf), (h_isl, h_conf) = _twice(port, str(tmp_path / "c"))
    want = io.StringIO()
    JPL.posterior_file(fasta, jp, islands_out=want, confidence_out=str(tmp_path / "j.npy"),
                       symbol_cache=str(tmp_path / "j"), engine="onehot", island_engine="host")
    assert m_isl == h_isl == want.getvalue() and h_isl
    np.testing.assert_array_equal(m_conf, h_conf)
    np.testing.assert_allclose(h_conf, np.load(str(tmp_path / "j.npy")), atol=2e-5)


def test_compare_file_with_a_cache_equals_jax(fasta, tmp_path, monkeypatch):
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    jm = JFAM.default_members()

    def port(prefix):
        buf = io.StringIO()
        TPL.compare_file(fasta, TFAM.default_members(), out=buf, symbol_cache=prefix,
                         device="cpu")
        return buf.getvalue()

    miss, hit = _twice(port, str(tmp_path / "c"))
    sessions = {m.name: Session(m.params, engine=e, name=f"s{i}", private_breaker=True)
                for i, (m, e) in enumerate(zip(jm, ["onehot", "pallas", None])) if e}
    want = io.StringIO()
    JPL.compare_file(fasta, jm, out=want, symbol_cache=str(tmp_path / "j"), sessions=sessions)
    assert miss == hit
    g, w = hit.splitlines(), want.getvalue().splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if not a.startswith("# model "):
            assert a == b
            continue
        a, b = a.split(), b.split()
        assert a[:4] + a[7:] == b[:4] + b[7:]
        np.testing.assert_allclose(float(a[4]), float(b[4]), rtol=1e-5)


def test_cli_symbol_cache_flags(fasta, tmp_path, monkeypatch, capsys):
    """--symbol-cache on decode, train, posterior, compare and run builds
    the cache once and reads it after; the files equal the uncached runs'."""
    monkeypatch.setattr(fb_seq, "DEFAULT_LANE_T", 1024)
    real = TPL.train_file
    monkeypatch.setattr(TPL, "train_file", lambda *a, **k: real(*a, chunk_size=CHUNK, **k))
    prefix = str(tmp_path / "cli")
    out = {}
    for use in (None, prefix, prefix):
        tag = "none" if use is None else ("hit" if "miss" in out else "miss")
        cache = [] if use is None else ["--symbol-cache", use]
        d = str(tmp_path / f"d.{tag}")
        m = str(tmp_path / f"m.{tag}")
        ri, rm = str(tmp_path / f"ri.{tag}"), str(tmp_path / f"rm.{tag}")
        po, cp = str(tmp_path / f"p.{tag}"), str(tmp_path / f"c.{tag}")
        runner = TCLI.main if tag != "hit" else (lambda argv: _strict(TCLI.main, argv))
        assert runner(["decode", fasta, "--islands-out", d, "--clean", *cache,
                       "--device", "cpu"]) == 0
        assert runner(["train", fasta, "--model-out", m, "--clean", "--iters", "1", *cache,
                       "--device", "cpu"]) == 0
        assert runner(["posterior", fasta, "--islands-out", po, *cache, "--device", "cpu"]) == 0
        assert runner(["compare", fasta, "--out", cp, *cache, "--device", "cpu"]) == 0
        assert runner(["run", fasta, fasta, "--islands-out", ri, "--model-out", rm, "--clean",
                       "--iters", "1", *cache, "--device", "cpu"]) == 0
        out[tag] = [open(p).read() for p in (d, m, po, cp, ri, rm)]
    capsys.readouterr()
    assert out["none"] == out["miss"] == out["hit"]
    assert os.path.exists(prefix + ".meta.npz")
