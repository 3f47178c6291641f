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

The skip policy takes the native codec (``utils.native``, built from
``csrc/codec.cpp``) exactly where the JAX package takes its own: the
multithreaded whole-buffer encode for files of ``_MT_THRESHOLD`` bytes or
more (:func:`encode_file`), the fused streaming header-strip and encode in
:func:`iter_encoded_blocks`, and the bulk encode of header-free blocks in
:func:`iter_fasta_records`.  The NumPy path is the parity oracle; the mask
and fail policies, and ``CPGISLAND_NATIVE=0``, take it.

Symbol caches (:func:`write_symbol_cache`, :func:`open_symbol_cache`,
:func:`encode_file_cached`, :func:`iter_fasta_records_cached`) store a
file's clean (FASTA-aware, skip) encode once, in the JAX package's format:
a cache written by either package is valid for the other.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional, Union

import numpy as np

from cpgisland_tpu_torch.utils import native

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
    """Stream-encode a file in bounded-memory blocks.  Header lines may span
    read boundaries; a small carry tracks them.  The skip policy takes the
    native fused kernel (the same bytes out as the NumPy path)."""
    _check_policy(invalid)
    use_native = invalid == "skip" and native.available()
    fasta_enc = native.FastaEncoder() if use_native and skip_headers else None
    in_header, at_line_start = False, True
    with open(path, "rb", buffering=0) as f:
        while True:
            data = f.read(read_size)
            if not data:
                return
            if use_native:
                syms = fasta_enc.feed(data) if skip_headers else native.encode(data)
            else:
                if skip_headers:
                    data, in_header, at_line_start = _strip_headers_stateful(
                        data, in_header, at_line_start
                    )
                syms = encode_bytes(data, invalid=invalid)
            if syms.size:
                yield syms


# Above this size the parallel whole-buffer native path wins over streaming;
# below it, thread spawn and the extra count pass cost more than they save.
_MT_THRESHOLD = 8 << 20


def encode_file(path: str, *, skip_headers: bool = False,
                invalid: str = "skip") -> np.ndarray:
    """Encode an entire file into one symbol array.  Files of
    ``_MT_THRESHOLD`` bytes or more take the multithreaded native path under
    the skip policy (peak memory: file size plus symbol count); smaller
    files, and the mask / fail policies, stream through
    :func:`iter_encoded_blocks`."""
    _check_policy(invalid)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size >= _MT_THRESHOLD and native.available() and invalid == "skip":
        return native.encode_mt(np.fromfile(path, dtype=np.uint8), fasta=skip_headers)
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
    record named "".  Blocks without a '>' encode in bulk (the native
    kernel under the skip policy)."""
    _check_policy(invalid)
    name = ""
    bufs: list[np.ndarray] = []
    have_record = False
    in_header = False
    header_frag = b""
    at_line_start = True

    def _bulk(seg: Union[bytes, memoryview]) -> np.ndarray:
        if isinstance(seg, memoryview):
            seg = bytes(seg)
        if invalid != "skip":
            return encode_bytes(seg, invalid=invalid)
        out = native.encode(seg)
        return out if out is not None else encode_bytes(seg)

    with open(path, "rb", buffering=0) as f:
        while True:
            data = f.read(read_size)
            if not data:
                break
            if not in_header and b">" not in data:
                syms = _bulk(data)
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
                syms = _bulk(memoryview(data)[i:nl_end])
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


# ---------------------------------------------------------------------------
# Symbol caches: a file's clean encode stored once (the JAX package's format,
# version 1): the symbols as a streamed .npy, memmap-loadable, so repeat runs
# read pages from the OS cache with no parse and no copy, and a .meta.npz of
# the record names, their offsets and the source's size and mtime_ns.
# FASTA-aware (clean) semantics and the skip policy only.

_CACHE_VERSION = 1


def _source_fingerprint(path: str) -> dict:
    st = os.stat(path)
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}


def symbol_cache_paths(cache: str) -> tuple[str, str]:
    """(symbols .npy path, metadata .npz path) of a cache prefix."""
    return cache + ".symbols.npy", cache + ".meta.npz"


def write_symbol_cache(path: str, cache: str) -> int:
    """Encode ``path`` (FASTA-aware) into a symbol cache at prefix ``cache``;
    returns the symbol count.  Both files are written under temporary names
    and renamed into place, symbols first and metadata last: a reader that
    validated the cache keeps its memmap of the old symbols (the rename
    unlinks the name, not the inode), and validation never sees metadata
    whose symbols are not in place."""
    from cpgisland_tpu_torch.utils.npystream import NpyStreamWriter

    sym_p, meta_p = symbol_cache_paths(cache)
    # The temporary names keep the extensions (np.savez appends ".npz"
    # otherwise) and carry the pid, so concurrent builders never collide.
    sym_tmp = f"{cache}.tmp.{os.getpid()}.symbols.npy"
    meta_tmp = f"{cache}.tmp.{os.getpid()}.meta.npz"
    # Fingerprint before the parse: a source replaced mid-encode leaves a
    # cache that validates as stale, never one that matches the new file.
    fp = _source_fingerprint(path)
    names: list[str] = []
    offsets: list[int] = [0]
    try:
        with NpyStreamWriter(sym_tmp, np.uint8) as w:
            for name, syms in iter_fasta_records(path):
                names.append(name)
                w.write(syms)
                offsets.append(w.count)
            total = w.count
        np.savez(meta_tmp, version=_CACHE_VERSION, names=np.asarray(names, dtype=object),
                 offsets=np.asarray(offsets, dtype=np.int64), **fp)
        os.rename(sym_tmp, sym_p)
        os.rename(meta_tmp, meta_p)
    finally:
        for p in (sym_tmp, meta_tmp):
            if os.path.exists(p):
                os.unlink(p)
    return total


def open_symbol_cache(path: str, cache: str):
    """(names, offsets, read-only symbols memmap) of a valid cache, else
    None.  Valid: the cache version and the source's size and mtime_ns
    match, so an edited FASTA invalidates its cache."""
    sym_p, meta_p = symbol_cache_paths(cache)
    if not (os.path.exists(sym_p) and os.path.exists(meta_p)):
        return None
    try:
        meta = np.load(meta_p, allow_pickle=True)
        fp = _source_fingerprint(path)
        if (int(meta["version"]) != _CACHE_VERSION or int(meta["size"]) != fp["size"]
                or int(meta["mtime_ns"]) != fp["mtime_ns"]):
            return None
        symbols = np.load(sym_p, mmap_mode="r")
        offsets = np.asarray(meta["offsets"], np.int64)
        if symbols.shape[0] != int(offsets[-1]):
            return None
        return list(meta["names"]), offsets, symbols
    except Exception:
        return None


def _open_or_build(path: str, cache: str):
    hit = open_symbol_cache(path, cache)
    if hit is None:
        write_symbol_cache(path, cache)
        hit = open_symbol_cache(path, cache)
    return hit


def encode_file_cached(path: str, cache: Optional[str], *, skip_headers: bool,
                       invalid: str = "skip") -> np.ndarray:
    """:func:`encode_file` through an optional read-through symbol cache.
    Only the clean encode (``skip_headers=True``, skip policy) is served
    from it; a hit is a read-only memmap."""
    if invalid != "skip":
        _check_policy(invalid)
        return encode_file(path, skip_headers=skip_headers, invalid=invalid)
    if cache is None or not skip_headers:
        return encode_file(path, skip_headers=skip_headers)
    hit = _open_or_build(path, cache)
    if hit is None:  # pragma: no cover - a racing writer or an unwritable directory
        return encode_file(path, skip_headers=True)
    return hit[2]


def iter_fasta_records_cached(path: str, cache: Optional[str] = None, *,
                              invalid: str = "skip"):
    """:func:`iter_fasta_records` through an optional read-through symbol
    cache (``cache``: a file prefix).  A valid cache yields read-only memmap
    slices (no parse, no copy); a missing or stale one is built first.  A
    policy other than skip bypasses the cache (logged once)."""
    if invalid != "skip":
        _check_policy(invalid)
        if cache is not None:
            logging.getLogger(__name__).info(
                "symbol cache bypassed: invalid-symbol policy %r differs from the "
                "cache's skip encoding", invalid)
        yield from iter_fasta_records(path, invalid=invalid)
        return
    if cache is None:
        yield from iter_fasta_records(path)
        return
    hit = _open_or_build(path, cache)
    if hit is None:  # pragma: no cover - a racing writer or an unwritable directory
        yield from iter_fasta_records(path)
        return
    names, offsets, symbols = hit
    for i, name in enumerate(names):
        yield name, symbols[offsets[i] : offsets[i + 1]]


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
