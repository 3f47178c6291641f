"""High-level driver: FASTA in -> island calls out (the reference's
``testModel``, CpGIslandFinder.java:227-344), on the card.

Counterpart of ``cpgisland_tpu/pipeline.py``'s :func:`decode_file`.

``compat=True`` reproduces the reference end to end: headers encoded as
bases, the remainder chunk dropped, 1 MiB decode chunks decoded and island
-called independently (islands clipped at chunk boundaries, java:256,
262-268).  ``compat=False`` is the clean path: FASTA-aware, no dropped
symbols, one exact decode per record so neither chunk nor record boundaries
clip or merge islands, optional min-length filter, and a record-name column
when the file has several records.  Small records (scaffolds) decode
together as one flat batch.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import IO, Optional, Union

import numpy as np
import torch

from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import islands as islands_mod
from cpgisland_tpu_torch.ops.islands import IslandCalls
from cpgisland_tpu_torch.ops.viterbi_parallel import viterbi_parallel_batch
from cpgisland_tpu_torch.parallel.decode import resolve_engine, viterbi_sharded
from cpgisland_tpu_torch.utils import chunking, codec

# Largest record decoded in one pass in clean mode; longer records need the
# span-wise decode, not ported yet.
CLEAN_DECODE_SPAN = 1 << 28

# Records at or below this size batch together into one flat decode (clean
# mode): real assemblies carry hundreds of small scaffolds beside the
# chromosomes.
SMALL_RECORD_MAX = 4 << 20


@dataclass
class DecodeResult:
    calls: IslandCalls
    n_symbols: int
    n_chunks: int
    # Wall seconds per phase ("encode", "decode", "islands").
    phases: dict = field(default_factory=dict)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default and is never
    swapped for the CPU silently: without a card the caller must ask for
    ``device="cpu"`` (the plain PyTorch versions of the kernels)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the decode kernels need an NVIDIA GPU; "
            "pass device='cpu' (CLI: --device cpu) to run their plain "
            "PyTorch versions instead"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev


@contextmanager
def _phase(phases: dict, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


def _check_invalid_symbols(invalid_symbols: str, compat: bool) -> None:
    if invalid_symbols not in codec.INVALID_POLICIES:
        raise ValueError(
            f"invalid_symbols must be one of {codec.INVALID_POLICIES}, got "
            f"{invalid_symbols!r}"
        )
    if invalid_symbols != "skip" and compat:
        raise ValueError(
            "invalid-symbol policies other than 'skip' need clean mode "
            "(compat reproduces the reference's skip-everything encode)"
        )


def _round_pow2(n: int, floor: int = 1 << 16) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _batch_paths(params: HmmParams, engine: str, chunks: np.ndarray,
                 lengths: np.ndarray) -> np.ndarray:
    """Flat batch decode of host [N, T] uint8 rows -> host int32 paths."""
    dev = params.device
    paths = viterbi_parallel_batch(
        params,
        torch.from_numpy(np.ascontiguousarray(chunks)).to(dev),  # uint8 upload
        torch.from_numpy(np.ascontiguousarray(lengths)).to(dev),
        return_score=False,
        engine=engine,
    )
    return paths.cpu().numpy()


def _decode_small_batch(params: HmmParams, batch: list, *, engine: str, min_len,
                        phases: dict) -> list:
    """Decode a batch of small records as one flat stream; islands per
    record.  Rows pad to a power-of-two length and at least 8 rows, so few
    distinct shapes occur across many scaffolds."""
    B = len(batch)
    sizes = [s.size for _, s in batch]
    Tpad = _round_pow2(max(sizes + [1]))
    Bp = _round_pow2(B, floor=8)
    rows = np.full((Bp, Tpad), chunking.PAD_SYMBOL, np.uint8)
    for i, (_, s) in enumerate(batch):
        rows[i, : s.size] = s
    lengths = np.zeros(Bp, np.int32)
    lengths[:B] = sizes
    with _phase(phases, "decode"):
        paths = _batch_paths(params, engine, rows, lengths)
    parts = []
    with _phase(phases, "islands"):
        for i, (name, symbols) in enumerate(batch):
            calls = islands_mod.call_islands(
                paths[i, : symbols.size], chunk=0, compat=False, min_len=min_len
            )
            parts.append(calls.with_names(name or "."))
    return parts


def _write_calls(calls: IslandCalls, islands_out: Union[str, IO[str]]) -> None:
    """Write island records (reference line format) to a path or open file."""
    own = isinstance(islands_out, str)
    f = open(islands_out, "w") if own else islands_out
    try:
        f.write(calls.format_lines())
    finally:
        if own:
            f.close()


def _finish_decode(calls, n_symbols, n_chunks, islands_out, phases=None) -> DecodeResult:
    if islands_out is not None:
        _write_calls(calls, islands_out)
    return DecodeResult(
        calls=calls, n_symbols=int(n_symbols), n_chunks=int(n_chunks),
        phases=dict(phases or {}),
    )


def decode_file(
    test_path: str,
    params: HmmParams,
    *,
    islands_out: Optional[Union[str, IO[str]]] = None,
    compat: bool = True,
    chunk_size: int = chunking.DECODE_CHUNK,
    device_batch: int = 8,
    min_len: Optional[int] = None,
    span: int = CLEAN_DECODE_SPAN,
    engine: str = "auto",
    invalid_symbols: str = "skip",
    device="cuda",
) -> DecodeResult:
    """Viterbi-decode a sequence file and call CpG islands.

    ``device`` (default "cuda"): where the decode runs; the model moves
    there.  compat mode decodes ``chunk_size`` chunks independently, in
    batches of ``device_batch``; clean mode decodes each FASTA record
    exactly and batches records of at most SMALL_RECORD_MAX symbols
    ``device_batch`` at a time.  ``invalid_symbols`` is the codec's
    skip/mask/fail policy (clean mode only)."""
    _check_invalid_symbols(invalid_symbols, compat)
    if params.n_states != 2 * params.n_symbols:
        raise ValueError(
            f"model has {params.n_states} states / {params.n_symbols} symbols, "
            "not the 2M-state X+/X- labeling the island caller assumes"
        )
    dev = resolve_device(device)
    params = params.to(dev)
    eng = resolve_engine(engine, params)
    phases: dict = {}

    if compat:
        with _phase(phases, "encode"):
            symbols = codec.encode_file(test_path, skip_headers=False)
        chunked = chunking.frame(symbols, chunk_size, drop_remainder=True)
        chunks, lengths = chunked.chunks, chunked.lengths
        n = chunked.num_chunks
        parts: list = []
        for lo in range(0, n, device_batch):
            hi = min(lo + device_batch, n)
            with _phase(phases, "decode"):
                batch_paths = _batch_paths(params, eng, chunks[lo:hi], lengths[lo:hi])
            with _phase(phases, "islands"):
                parts.extend(
                    islands_mod.call_islands(
                        batch_paths[i][: int(lengths[lo + i])],
                        chunk=lo + i, chunk_size=chunk_size, compat=True,
                    )
                    for i in range(hi - lo)
                )
        calls = IslandCalls.concatenate(parts)
        return _finish_decode(calls, chunked.total, n, islands_out, phases)

    # Clean path: one exact decode per FASTA record, islands per record with
    # per-record 1-based coordinates (an island never spans two records).
    parts = []
    n_sym = 0
    n_records = 0

    def decode_one(rec_name: str, symbols: np.ndarray) -> None:
        if symbols.size > span:
            raise NotImplementedError(
                f"record {rec_name!r} has {symbols.size} symbols, more than the "
                f"single-pass span ({span}); the span-wise decode is not "
                "ported yet"
            )
        with _phase(phases, "decode"):
            if symbols.size == 0:
                full = np.zeros(0, dtype=np.int32)
            else:
                full = viterbi_sharded(params, symbols, engine=eng)
        with _phase(phases, "islands"):
            calls = islands_mod.call_islands(full, chunk=0, compat=False, min_len=min_len)
        # "." = headerless leading sequence (keeps the name column parseable).
        parts.append(calls.with_names(rec_name or "."))

    def flush_small(batch: list) -> None:
        if not batch:
            return
        if len(batch) == 1:
            decode_one(*batch[0])
            return
        parts.extend(
            _decode_small_batch(params, batch, engine=eng, min_len=min_len, phases=phases)
        )

    records = codec.iter_fasta_records(test_path, invalid=invalid_symbols)
    pending: list = []
    while True:
        # The parse is timed as its own phase; records stream one at a time.
        with _phase(phases, "encode"):
            rec = next(records, None)
        if rec is None:
            break
        rec_name, symbols = rec
        n_records += 1
        n_sym += symbols.size
        if symbols.size <= SMALL_RECORD_MAX:
            pending.append((rec_name, symbols))
            if len(pending) >= device_batch:
                flush_small(pending)
                pending = []
        else:
            flush_small(pending)
            pending = []
            decode_one(rec_name, symbols)
    flush_small(pending)
    calls = IslandCalls.concatenate(parts)
    if n_records <= 1:
        # Single-record files keep the reference's bare 5-column format.
        calls = dataclasses.replace(calls, names=None)
    return _finish_decode(calls, n_sym, n_records, islands_out, phases)
