"""DNA sequence codec: text -> uint8 symbol arrays (NumPy paths).

Counterpart of ``cpgisland_tpu/utils/codec.py``.  Reference semantics
(CpGIslandFinder.java:112-128 and :238-254): map A/a->0, C/c->1, G/g->2,
T/t->3 and silently skip every other character; the reference encodes FASTA
header lines as bases, kept behind ``skip_headers=False`` (compat) and fixed
by ``skip_headers=True`` (clean).  A 256-entry lookup table over raw bytes
does the work.

Invalid-symbol policy (clean mode): "skip" drops every non-base byte (the
reference), "mask" encodes a non-base, non-whitespace byte as the PAD
sentinel (an identity DP step, so coordinates keep matching the FASTA),
"fail" raises :class:`InvalidSymbolError`.  Line breaks and other
whitespace are file format, never invalid.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np

A, C, G, T = 0, 1, 2, 3
N_SYMBOLS = 4
SKIP = 0xFF  # sentinel for "not a base" in the LUT

_LUT = np.full(256, SKIP, dtype=np.uint8)
for _ch, _val in ((b"Aa", A), (b"Cc", C), (b"Gg", G), (b"Tt", T)):
    _LUT[_ch[0]] = _val
    _LUT[_ch[1]] = _val

INVALID_POLICIES = ("skip", "mask", "fail")
MASK_SYMBOL = N_SYMBOLS  # == the chunking PAD sentinel: an identity DP step
PAD = MASK_SYMBOL

_WS_LUT = np.zeros(256, dtype=bool)
for _b in b" \t\r\n\v\f":
    _WS_LUT[_b] = True


class InvalidSymbolError(ValueError):
    """A byte that is neither a base nor whitespace under ``invalid='fail'``."""

    def __init__(self, count: int, first_byte: int, first_offset: int):
        super().__init__(
            f"{count} invalid symbol byte(s) in the input (first: "
            f"{bytes([first_byte])!r} at buffer offset {first_offset}); "
            "pass invalid='skip' to drop them (the reference's behavior) or "
            "invalid='mask' to encode them as the PAD sentinel"
        )
        self.count = count
        self.first_byte = first_byte
        self.first_offset = first_offset


def _check_policy(invalid: str) -> None:
    if invalid not in INVALID_POLICIES:
        raise ValueError(
            f"invalid-symbol policy must be one of {INVALID_POLICIES}, "
            f"got {invalid!r}"
        )


def encode_bytes(
    data: Union[bytes, bytearray, memoryview, np.ndarray], *, invalid: str = "skip"
) -> np.ndarray:
    """Encode raw sequence bytes to a uint8 symbol array under the
    ``invalid`` policy (see the module docstring)."""
    _check_policy(invalid)
    raw = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    coded = _LUT[raw]
    is_base = coded != SKIP
    if invalid == "skip":
        return coded[is_base]
    inv = ~is_base & ~_WS_LUT[raw]
    n_inv = int(inv.sum())
    if n_inv and invalid == "fail":
        off = int(np.flatnonzero(inv)[0])
        raise InvalidSymbolError(n_inv, int(raw[off]), off)
    if invalid == "mask":
        keep = is_base | inv
        return np.where(inv, np.uint8(MASK_SYMBOL), coded)[keep]
    return coded[is_base]


def encode(text: Union[str, bytes], *, invalid: str = "skip") -> np.ndarray:
    """Encode a string (or bytes) of sequence text."""
    if isinstance(text, str):
        text = text.encode("ascii", errors="replace")
    return encode_bytes(text, invalid=invalid)


def _strip_headers_stateful(
    data: bytes, in_header: bool, at_line_start: bool
) -> tuple[bytes, bool, bool]:
    """Strip header spans: a header opens only at a '>' that begins a line.
    The carry (in_header, at_line_start) lets headers span read blocks."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        if in_header:
            nl = data.find(b"\n", i)
            if nl == -1:
                return bytes(out), True, False
            i = nl + 1
            in_header = False
            at_line_start = True
        else:
            if at_line_start and data[i : i + 1] == b">":
                in_header = True
                continue
            nl = data.find(b"\n", i)
            if nl == -1:
                out += data[i:]
                return bytes(out), False, False
            out += data[i : nl + 1]
            i = nl + 1
            at_line_start = True
    return bytes(out), in_header, at_line_start


def strip_fasta_headers(data: bytes) -> bytes:
    """Remove FASTA header lines ('>' at line start, through end-of-line)."""
    return _strip_headers_stateful(data, False, True)[0]


def iter_encoded_blocks(
    path: str,
    *,
    skip_headers: bool = False,
    read_size: int = 1 << 24,
    invalid: str = "skip",
) -> Iterator[np.ndarray]:
    """Stream-encode a file in bounded-memory blocks."""
    _check_policy(invalid)
    in_header, at_line_start = False, True
    with open(path, "rb", buffering=0) as f:
        while True:
            data = f.read(read_size)
            if not data:
                return
            if skip_headers:
                data, in_header, at_line_start = _strip_headers_stateful(
                    data, in_header, at_line_start
                )
            syms = encode_bytes(data, invalid=invalid)
            if syms.size:
                yield syms


def encode_file(path: str, *, skip_headers: bool = False, invalid: str = "skip") -> np.ndarray:
    """Encode an entire file into one symbol array."""
    blocks = list(iter_encoded_blocks(path, skip_headers=skip_headers, invalid=invalid))
    if not blocks:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(blocks)


def iter_fasta_records(
    path: str, *, read_size: int = 1 << 24, invalid: str = "skip"
) -> Iterator[tuple[str, np.ndarray]]:
    """Stream (name, symbols) per FASTA record.

    The record name is the header token up to the first whitespace (">chr21
    GRCh38 alt" -> "chr21"); leading sequence before any header yields a
    record named "".  Blocks without a '>' encode in bulk."""
    _check_policy(invalid)
    name = ""
    bufs: list[np.ndarray] = []
    have_record = False
    in_header = False
    header_frag = b""
    at_line_start = True

    with open(path, "rb", buffering=0) as f:
        while True:
            data = f.read(read_size)
            if not data:
                break
            if not in_header and b">" not in data:
                syms = encode_bytes(data, invalid=invalid)
                if syms.size:
                    bufs.append(syms)
                    have_record = True
                at_line_start = data.endswith(b"\n")
                continue
            i, n = 0, len(data)
            while i < n:
                if in_header:
                    nl = data.find(b"\n", i)
                    if nl == -1:
                        header_frag += data[i:]
                        i = n
                        continue
                    header_frag += data[i:nl]
                    name = (
                        header_frag.decode("ascii", "replace").split()[0]
                        if header_frag.strip() else ""
                    )
                    header_frag = b""
                    in_header = False
                    at_line_start = True
                    i = nl + 1
                    continue
                if at_line_start and data[i : i + 1] == b">":
                    if have_record:
                        yield name, _concat(bufs)
                        bufs = []
                    have_record = True
                    in_header = True
                    header_frag = b""
                    i += 1
                    continue
                nxt = data.find(b">", i)
                nl_end = n if nxt == -1 else nxt
                # '>' only opens a header at a line start; scan to the last
                # newline before it so a mid-line '>' stays in sequence data.
                if nxt != -1 and data[nxt - 1 : nxt] != b"\n":
                    nl = data.find(b"\n", nxt)
                    nl_end = n if nl == -1 else nl + 1
                syms = encode_bytes(memoryview(data)[i:nl_end], invalid=invalid)
                if syms.size:
                    bufs.append(syms)
                    have_record = True
                at_line_start = data[nl_end - 1 : nl_end] == b"\n"
                i = nl_end
    if in_header and header_frag.strip():
        name = header_frag.decode("ascii", "replace").split()[0]
    if have_record:
        yield name, _concat(bufs)


def _concat(bufs: list) -> np.ndarray:
    if not bufs:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(bufs)


def recode_pairs(symbols: np.ndarray, n_symbols: int = N_SYMBOLS,
                 prev: Optional[int] = None) -> np.ndarray:
    """Recode a base-alphabet stream to the PAIR (dinucleotide) alphabet:
    ``out[t] = symbols[t-1] * n_symbols + symbols[t]``, position-aligned
    with the input, uint8 (PAD = ``n_symbols ** 2``).

    A position with no real left context (the first one unless ``prev``
    gives the symbol before the stream, and any real position right after
    a PAD) recodes to the SELF-CONTEXT pair ``(cur, cur)``: in-alphabet and
    chain-consistent, so the structural zeros of pair-chained models such
    as ``presets.dinuc_cpg`` never see a dead chain.  A PAD input symbol
    stays PAD."""
    if n_symbols * n_symbols >= 255:
        raise ValueError(f"pair alphabet {n_symbols}^2 does not fit the uint8 symbol stream")
    s = np.asarray(symbols)
    out = np.full(s.shape, n_symbols * n_symbols, dtype=np.uint8)
    if s.size == 0:
        return out
    cur = s.astype(np.int32)
    prv = np.empty_like(cur)
    prv[1:] = cur[:-1]
    prv[0] = int(prev) if prev is not None and 0 <= int(prev) < n_symbols else n_symbols
    real = cur < n_symbols
    prv = np.where(real & (prv >= n_symbols), cur, prv)
    out[real] = (prv[real] * n_symbols + cur[real]).astype(np.uint8)
    return out
