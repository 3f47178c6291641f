"""Codec and chunk framing of the PyTorch port vs the JAX package: equal
arrays (exact) for lowercase, N, headers and the skip/mask/fail policies."""

import numpy as np
import pytest

from cpgisland_tpu.utils import chunking as JC
from cpgisland_tpu.utils import codec as JK
from cpgisland_tpu_torch.utils import chunking as TC
from cpgisland_tpu_torch.utils import codec as TK

_FASTA = (
    b"acgtNNac\n"  # headerless leading sequence
    b">chr1 GRCh38 alt\nACGTacgtNNNNcgCG\nttaa>notaheader\n"
    b">chr2\n\nGGCCnnRYacgt\r\n"
    b">empty\n"
    b">chr3 x\nAC-GT*TT\n"
)


@pytest.mark.parametrize("invalid", ["skip", "mask"])
def test_encode_matches(rng, invalid):
    text = bytes(rng.choice(list(b"ACGTacgtNnRY- \n>"), size=5000))
    assert np.array_equal(TK.encode(text, invalid=invalid), JK.encode(text, invalid=invalid))
    assert np.array_equal(
        TK.encode(text.decode(), invalid=invalid), JK.encode(text.decode(), invalid=invalid)
    )


def test_fail_policy_raises_alike():
    with pytest.raises(TK.InvalidSymbolError) as t:
        TK.encode(b"ACGT\nACNT", invalid="fail")
    with pytest.raises(JK.InvalidSymbolError) as j:
        JK.encode(b"ACGT\nACNT", invalid="fail")
    assert (t.value.count, t.value.first_byte, t.value.first_offset) == (
        j.value.count, j.value.first_byte, j.value.first_offset)
    assert np.array_equal(TK.encode(b"AC GT\n", invalid="fail"), JK.encode(b"AC GT\n"))
    with pytest.raises(ValueError):
        TK.encode(b"ACGT", invalid="drop")


@pytest.mark.parametrize("skip_headers", [False, True])
@pytest.mark.parametrize("read_size", [7, 1 << 24])
def test_encode_file_matches(tmp_path, skip_headers, read_size):
    p = tmp_path / "x.fa"
    p.write_bytes(_FASTA)
    want = JK.encode_file(str(p), skip_headers=skip_headers)
    got = np.concatenate(list(TK.iter_encoded_blocks(
        str(p), skip_headers=skip_headers, read_size=read_size)))
    assert np.array_equal(got, want)
    assert np.array_equal(TK.encode_file(str(p), skip_headers=skip_headers), want)
    assert TK.strip_fasta_headers(_FASTA) == JK.strip_fasta_headers(_FASTA)


@pytest.mark.parametrize("invalid", ["skip", "mask"])
@pytest.mark.parametrize("read_size", [5, 64, 1 << 24])
def test_iter_fasta_records_matches(tmp_path, invalid, read_size):
    p = tmp_path / "x.fa"
    p.write_bytes(_FASTA)
    want = list(JK.iter_fasta_records(str(p), read_size=read_size, invalid=invalid))
    got = list(TK.iter_fasta_records(str(p), read_size=read_size, invalid=invalid))
    assert [n for n, _ in got] == [n for n, _ in want] == ["", "chr1", "chr2", "empty", "chr3"]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("n", [0, 5, 4096, 10_000])
@pytest.mark.parametrize("drop", [False, True])
def test_frame_matches(rng, n, drop):
    syms = rng.integers(0, 4, size=n).astype(np.uint8)
    a = TC.frame(syms, 4096, drop_remainder=drop)
    b = JC.frame(syms, 4096, drop_remainder=drop)
    assert np.array_equal(a.chunks, b.chunks) and np.array_equal(a.lengths, b.lengths)
    assert a.total == b.total and a.lengths.dtype == np.int32
    assert TC.PAD_SYMBOL == JC.PAD_SYMBOL == TK.PAD == TK.MASK_SYMBOL
    assert TC.DECODE_CHUNK == JC.DECODE_CHUNK
