"""Chunk framing: symbol streams -> fixed-size [num_chunks, chunk_size] batches.

Counterpart of ``cpgisland_tpu/utils/chunking.py``.  The reference decodes in
chunks of 0x100000 symbols and drops the trailing remainder
(CpGIslandFinder.java:256-259) — ``drop_remainder=True``, the compat mode;
the clean mode pads the last chunk with PAD_SYMBOL and keeps true lengths.
:func:`bucket_records` lays whole FASTA records out for the per-record
whole-sequence trainer (``train.backends.Seq2DBackend``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TRAIN_CHUNK = 0x10000  # CpGIslandFinder.java:130 (training shards)
DECODE_CHUNK = 0x100000  # CpGIslandFinder.java:256
PAD_SYMBOL = 4  # one past the 4 real symbols; ops treat it as "no observation"


def upload(arr, device) -> torch.Tensor:
    """A host array (or a tensor) on ``device``.  A read-only array (a
    symbol cache's memmap slice) is copied first, so no tensor ever aliases
    the mapping."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


@dataclass(frozen=True)
class Chunked:
    """chunks [num_chunks, chunk_size] uint8 (PAD_SYMBOL in padded tails),
    lengths [num_chunks] int32 true lengths, total real symbols framed."""

    chunks: np.ndarray
    lengths: np.ndarray
    total: int

    @property
    def num_chunks(self) -> int:
        return int(self.chunks.shape[0])

    @property
    def chunk_size(self) -> int:
        return int(self.chunks.shape[1])


def frame(symbols: np.ndarray, chunk_size: int, *, drop_remainder: bool = False) -> Chunked:
    """Frame a 1-D symbol array into fixed-size chunks (``drop_remainder``:
    the reference's silent drop of the trailing partial chunk)."""
    symbols = np.ascontiguousarray(symbols, dtype=np.uint8)
    n = symbols.shape[0]
    n_full, rem = divmod(n, chunk_size)
    if drop_remainder or rem == 0:
        chunks = symbols[: n_full * chunk_size].reshape(n_full, chunk_size)
        lengths = np.full(n_full, chunk_size, dtype=np.int32)
        return Chunked(chunks=chunks, lengths=lengths, total=n_full * chunk_size)
    chunks = np.full((n_full + 1, chunk_size), PAD_SYMBOL, dtype=np.uint8)
    chunks[:n_full] = symbols[: n_full * chunk_size].reshape(n_full, chunk_size)
    chunks[n_full, :rem] = symbols[n_full * chunk_size :]
    lengths = np.full(n_full + 1, chunk_size, dtype=np.int32)
    lengths[n_full] = rem
    return Chunked(chunks=chunks, lengths=lengths, total=n)


def pad_to_multiple(chunked: Chunked, multiple: int) -> Chunked:
    """Pad the batch with empty (all-PAD, length-0) chunks to a multiple
    of ``multiple`` rows, so it splits evenly over a mesh axis: empty
    chunks add exactly-zero statistics."""
    n = chunked.num_chunks
    target = -(-n // multiple) * multiple
    if target == n:
        return chunked
    extra = target - n
    T = np.asarray(chunked.chunks).shape[1] if n else 1
    return Chunked(
        chunks=np.concatenate([chunked.chunks, np.full((extra, T), PAD_SYMBOL, np.uint8)]),
        lengths=np.concatenate([chunked.lengths, np.zeros(extra, np.int32)]),
        total=chunked.total,
    )


@dataclass(frozen=True)
class Bucketed:
    """A length-bucketed batch of whole sequences (the seq2d training
    input): each record pads only to its power-of-two size class, so host
    memory stays near the raw input's, not records x the longest record.

    chunks:  tuple of [N_g, T_g] uint8 group matrices (PAD in tails)
    lengths: tuple of [N_g] int32 true lengths
    total:   total real symbols across all groups
    """

    chunks: tuple
    lengths: tuple
    total: int

    @property
    def num_chunks(self) -> int:
        return int(sum(c.shape[0] for c in self.chunks))

    @property
    def num_groups(self) -> int:
        return len(self.chunks)


def bucket_records(records, *, floor: int = 1 << 16, budget: int = 1 << 28,
                   pad_value: int = PAD_SYMBOL) -> Bucketed:
    """Stream whole records (an iterable of 1-D symbol arrays) into
    power-of-two length buckets: each record pads to the next power of two
    >= ``floor``; a size class's group closes when it reaches ``budget``
    total symbols.  Group order follows first-record arrival (a group is
    emitted when it closes; the open ones at the end, in arrival order of
    their classes); rows within a group follow file order."""
    open_groups: dict = {}  # T -> pending raw records
    sealed: list = []
    total = 0

    def seal(T: int) -> None:
        recs = open_groups.pop(T)
        mat = np.full((len(recs), T), pad_value, np.uint8)
        lens = np.empty(len(recs), np.int32)
        for i, r in enumerate(recs):
            mat[i, : r.shape[0]] = r
            lens[i] = r.shape[0]
        sealed.append((mat, lens))

    for rec in records:
        rec = np.ascontiguousarray(rec, dtype=np.uint8)
        n = rec.shape[0]
        total += n
        T = floor
        while T < n:
            T <<= 1
        open_groups.setdefault(T, []).append(rec)
        if len(open_groups[T]) >= max(1, budget // T):
            seal(T)
    for T in list(open_groups):
        seal(T)
    if not sealed:
        raise ValueError("no records to bucket")
    return Bucketed(chunks=tuple(c for c, _ in sealed), lengths=tuple(l for _, l in sealed),
                    total=total)
