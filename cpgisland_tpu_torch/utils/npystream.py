"""Streaming one-pass .npy writer (header patched with the final length).

Counterpart of ``cpgisland_tpu/utils/npystream.py``, and byte-identical to
it for the same arrays.  Per-position outputs of a genome (the posterior
confidence, MPM paths) are written record by record as they are computed:
collecting them to hand ``numpy.save`` one array would hold the genome's
output twice in host memory.  The total length is unknown until the FASTA
ends, so the writer reserves a fixed header slot, streams the raw element
bytes, and writes the real npy 1.0 header on close; the file then loads
with ``numpy.load`` (``mmap_mode`` included) as a 1-D array.
"""

from __future__ import annotations

import struct

import numpy as np

# npy 1.0: magic (6) + version (2) + header-length uint16 (2) + header text.
_SLOT = 128
_MAGIC = b"\x93NUMPY\x01\x00"


class NpyStreamWriter:
    """Append-only 1-D .npy writer; use as a context manager or call close().
    The final header (dtype descr and an element count of up to ~19 digits)
    fits the 128-byte slot."""

    def __init__(self, path: str, dtype):
        self.dtype = np.dtype(dtype)
        self._n = 0
        self._f = open(path, "wb")
        self._f.write(b"\x00" * _SLOT)

    def write(self, arr) -> None:
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        arr.tofile(self._f)
        self._n += arr.size

    @property
    def count(self) -> int:
        return self._n

    def close(self) -> None:
        if self._f.closed:
            return
        header = (
            "{'descr': %r, 'fortran_order': False, 'shape': (%d,), }"
            % (np.lib.format.dtype_to_descr(self.dtype), self._n)
        ).encode("latin1")
        pad = _SLOT - len(_MAGIC) - 2 - len(header) - 1
        if pad < 0:  # pragma: no cover — needs a >100-char dtype descr
            raise ValueError("npy header slot overflow")
        header += b" " * pad + b"\n"
        self._f.seek(0)
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<H", len(header)))
        self._f.write(header)
        self._f.close()

    def __enter__(self) -> "NpyStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
