"""Chunk framing: symbol streams -> fixed-size [num_chunks, chunk_size] batches.

Counterpart of ``cpgisland_tpu/utils/chunking.py``.  The reference decodes in
chunks of 0x100000 symbols and drops the trailing remainder
(CpGIslandFinder.java:256-259) — ``drop_remainder=True``, the compat mode;
the clean mode pads the last chunk with PAD_SYMBOL and keeps true lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TRAIN_CHUNK = 0x10000  # CpGIslandFinder.java:130 (training shards)
DECODE_CHUNK = 0x100000  # CpGIslandFinder.java:256
PAD_SYMBOL = 4  # one past the 4 real symbols; ops treat it as "no observation"


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
