"""High-level driver on the card: FASTA in -> trained model / island calls
out (the reference's ``trainModel`` and ``testModel``,
CpGIslandFinder.java:102-225 and :227-344, and its ``main``).

Counterpart of ``cpgisland_tpu/pipeline.py``'s :func:`train_file`,
:func:`decode_file`, :func:`posterior_file`, :func:`compare_file` and
:func:`run`.

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
import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import IO, Optional, Union

import numpy as np
import torch

from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import HmmParams, dump_text
from cpgisland_tpu_torch.ops import fb_seq
from cpgisland_tpu_torch.ops import islands as islands_mod
from cpgisland_tpu_torch.ops import islands_device, viterbi_onehot
from cpgisland_tpu_torch.ops.islands import IslandCalls
from cpgisland_tpu_torch.ops.viterbi_parallel import viterbi_parallel_batch
from cpgisland_tpu_torch.parallel import posterior as post
from cpgisland_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh
from cpgisland_tpu_torch.parallel.decode import (
    _prev_real_symbol,
    resolve_engine,
    viterbi_sharded,
    viterbi_sharded_spans,
)
from cpgisland_tpu_torch.train import baum_welch
from cpgisland_tpu_torch.utils import chunking, codec
from cpgisland_tpu_torch.utils.npystream import NpyStreamWriter

log = logging.getLogger(__name__)

# Largest record decoded in one pass in clean mode; longer records decode
# span by span with exact boundary messages threaded between the spans
# (parallel.decode.viterbi_sharded_spans): the span bounds device memory,
# not the result.
CLEAN_DECODE_SPAN = 1 << 28

# Records at or below this size batch together into one flat decode (clean
# mode): real assemblies carry hundreds of small scaffolds beside the
# chromosomes.
SMALL_RECORD_MAX = 4 << 20


# The device island engine never grows its output columns past this many
# calls (4 Mi slots = 96 MiB of int32 columns): a count beyond it means a
# degenerate input, where a clear cap error beats an opaque device OOM.
ISLAND_CAP_CEILING = 1 << 22


@dataclass
class DecodeResult:
    calls: IslandCalls
    n_symbols: int
    # compat: decode chunks; clean: spans decoded (one per record up to the
    # span, as in the JAX package).
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
            "CUDA is not available: the kernels need an NVIDIA GPU; "
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


def island_layout_error(params: HmmParams, island_states=None) -> Optional[str]:
    """The K = 2M island-caller pairing check, shared by decode_file and the
    CLI's parse-time validation.  The built-in caller reads base identity
    out of state ids, which is meaningful only for the reference's 2M-state
    X+/X- labeling (CpGIslandFinder.java:182-189); other models need the
    observation-based caller.  Returns an error message, or None."""
    if island_states is None and params.n_states != 2 * params.n_symbols:
        return (
            f"model has {params.n_states} states / {params.n_symbols} symbols, "
            "not the 2M-state X+/X- labeling the built-in island caller "
            "assumes — pass island_states=(...) (clean mode) to use the "
            "observation-based caller"
        )
    return None


def _check_symbol_cache(symbol_cache: Optional[str], compat: bool) -> None:
    if symbol_cache is not None and compat:
        raise ValueError("symbol_cache is FASTA-aware — use compat=False (--clean)")


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


def _sync(dev: torch.device) -> None:
    """Wait for the card: the decode phase ends when its kernels have run,
    not when they were queued (else the islands phase is billed for it)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batch_paths(params: HmmParams, eng: str, chunks: np.ndarray,
                 lengths: np.ndarray) -> torch.Tensor:
    """Batch decode of host [N, T] uint8 rows -> int32 paths on the params'
    device: the flat reset-step stream for onehot, the dense batch (each
    record exactly as alone) for the dense engines."""
    dev = params.device
    return viterbi_parallel_batch(
        params,
        chunking.upload(chunks, dev),  # uint8 upload
        chunking.upload(lengths, dev),
        return_score=False,
        engine=eng,
    )


def _resolve_island_engine(island_engine: str, *, dev: torch.device, device_eligible: bool,
                           ineligible_msg: str, island_cap: Optional[int]):
    """(use_device_islands, cap_box): 'auto' calls islands on the card in
    clean mode, 'device' wherever the decode runs (the CPU too), 'host' on
    the host.  cap_box is a one-element list shared by every record of the
    run, so a cap grown by one overflow is kept for the rest."""
    if island_engine not in ("auto", "host", "device"):
        raise ValueError(f"island_engine must be auto|host|device, got {island_engine!r}")
    if island_engine == "device" and not device_eligible:
        raise ValueError(ineligible_msg)
    use_device = island_engine == "device" or (
        island_engine == "auto" and device_eligible and dev.type == "cuda")
    cap = islands_device.DEFAULT_CAP if island_cap is None else int(island_cap)
    if cap > ISLAND_CAP_CEILING:
        log.warning("island_cap %d exceeds the %d ceiling; clamping", cap, ISLAND_CAP_CEILING)
        cap = ISLAND_CAP_CEILING
    return use_device, [cap]


def _grow_cap_or_raise(e: islands_device.IslandCapOverflow, cap_box: list) -> None:
    """Grow cap_box to the next power of two that holds the true count, or
    re-raise when the count exceeds the ceiling."""
    if e.n > ISLAND_CAP_CEILING:
        raise islands_device.IslandCapOverflow(e.n, cap_box[0]) from None
    new_cap = min(_round_pow2(e.n + 1, floor=2 * cap_box[0]), ISLAND_CAP_CEILING)
    log.warning(
        "island calls (%d) overflowed cap=%d; retrying the calling pass with "
        "cap=%d (decode not re-run)", e.n, cap_box[0], new_cap,
    )
    cap_box[0] = new_cap


def _device_calls_retry(fn, *args, cap_box: list, **kwargs) -> IslandCalls:
    """Device island calling that survives cap overflow: the overflow
    carries the true count, so the retry re-runs only the calling pass on
    the decoded path, still on the device, at a sufficient cap."""
    while True:
        try:
            return fn(*args, cap=cap_box[0], **kwargs)
        except islands_device.IslandCapOverflow as e:
            _grow_cap_or_raise(e, cap_box)


def _record_calls(path, symbols: np.ndarray, *, island_states, min_len, use_device: bool,
                  cap_box: list) -> IslandCalls:
    """Clean-mode islands of one record from its path (a device tensor for
    the device engine, a host array otherwise)."""
    if use_device:
        if island_states is not None:
            return _device_calls_retry(
                islands_device.call_islands_device_obs, path,
                chunking.upload(symbols, path.device), island_states=island_states,
                min_len=min_len, cap_box=cap_box)
        return _device_calls_retry(islands_device.call_islands_device, path,
                                   min_len=min_len, cap_box=cap_box)
    if island_states is not None:
        return islands_mod.call_islands_obs(path, symbols, island_states=island_states,
                                            min_len=min_len)
    return islands_mod.call_islands(path, chunk=0, compat=False, min_len=min_len)


def _batched_device_calls(params: HmmParams, paths: torch.Tensor, rows: np.ndarray,
                          lengths: np.ndarray, batch: list, *, island_states, min_len,
                          cap_box: list) -> list:
    """ONE device island call over a padded [Bp, Tpad] batch of paths.
    Masked tails and one separator column become a non-island state so no
    run crosses records; each call's record is recovered from its
    coordinate.  Returns per-record IslandCalls in batch order."""
    Bp, Tpad = paths.shape
    dev = paths.device
    stride = Tpad + 1
    # Background: N_ISLAND_STATES for the 8-state labeling, n_states (an id
    # no state uses) for island_states sets.
    fill = islands_mod.N_ISLAND_STATES if island_states is None else params.n_states
    mask = torch.arange(Tpad, device=dev)[None, :] < torch.from_numpy(lengths).to(dev)[:, None]
    masked = torch.where(mask, paths, fill)
    sep = torch.full((Bp, 1), fill, dtype=masked.dtype, device=dev)
    flat = torch.cat([masked, sep], dim=1).reshape(-1)
    if island_states is None:
        all_calls = _device_calls_retry(islands_device.call_islands_device, flat,
                                        min_len=min_len, cap_box=cap_box)
    else:
        obs = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        obs_flat = torch.cat([obs, torch.zeros((Bp, 1), dtype=obs.dtype, device=dev)],
                             dim=1).reshape(-1)
        all_calls = _device_calls_retry(islands_device.call_islands_device_obs, flat,
                                        obs_flat, island_states=island_states,
                                        min_len=min_len, cap_box=cap_box)
    rec_of = (all_calls.beg - 1) // stride
    parts = []
    for i, (name, _) in enumerate(batch):
        sel = rec_of == i
        parts.append(IslandCalls(
            beg=all_calls.beg[sel] - i * stride, end=all_calls.end[sel] - i * stride,
            length=all_calls.length[sel], gc_content=all_calls.gc_content[sel],
            oe_ratio=all_calls.oe_ratio[sel],
        ).with_names(name or "."))
    return parts


def _pad_small_batch(batch: list):
    """Host [Bp, Tpad] uint8 rows and [Bp] lengths of a small-record batch:
    rows pad to a power-of-two length and at least 8 rows (zero-length pad
    rows), so few distinct shapes occur across many scaffolds."""
    sizes = [s.size for _, s in batch]
    Tpad = _round_pow2(max(sizes + [1]))
    Bp = _round_pow2(len(batch), floor=8)
    rows = np.full((Bp, Tpad), chunking.PAD_SYMBOL, np.uint8)
    for i, (_, s) in enumerate(batch):
        rows[i, : s.size] = s
    lengths = np.zeros(Bp, np.int32)
    lengths[: len(batch)] = sizes
    return rows, lengths


def _decode_small_batch(params: HmmParams, batch: list, *, engine: str, min_len,
                        island_states, use_device: bool, cap_box: list,
                        phases: dict, want_paths: bool = False):
    """Decode a batch of small records (:func:`_pad_small_batch` rows) in
    one batched decode; islands per record.  Small records that start with
    PAD stay on the flat onehot batch, as in the JAX package.  Returns
    ([IslandCalls per record], [int8 host path per record] when
    ``want_paths``, else [])."""
    rows, lengths = _pad_small_batch(batch)
    with _phase(phases, "decode"):
        paths = _batch_paths(params, engine, rows, lengths)
        if use_device:
            _sync(paths.device)
        else:
            paths = paths.cpu().numpy()
    with _phase(phases, "islands"):
        if use_device:
            parts = _batched_device_calls(params, paths, rows, lengths, batch,
                                          island_states=island_states, min_len=min_len,
                                          cap_box=cap_box)
        else:
            parts = [
                _record_calls(paths[i, : symbols.size], symbols, island_states=island_states,
                              min_len=min_len, use_device=False, cap_box=cap_box
                              ).with_names(name or ".")
                for i, (name, symbols) in enumerate(batch)
            ]
    if not want_paths:
        return parts, []
    host = np.asarray(paths)  # the dump forces host islands: already on the host
    return parts, [host[i, : s.size].astype(np.int8) for i, (_, s) in enumerate(batch)]


def _decode_small_batch_stacked(params_list: list, batch: list, owners: list, *, min_len,
                                island_states_list: list, use_device_list: list,
                                cap_boxes: list, phases: dict):
    """Decode ONE small-record batch under M models of one alphabet in one
    stacked flat launch set (``viterbi_onehot.decode_batch_flat_stacked``:
    B26, B27, B28 once each) — the serve broker's mixed-model decode flush
    unit.  Record i's island calls come from its owning model's path
    (``owners[i]`` indexes ``params_list``), called per model on that
    model's records only: on the card through one batched island call over
    a power-of-two sub-batch (zero-length pad rows emit no calls), or on the
    host after one fetch of the model's rows.

    Record i's path equals ``owners[i]``'s own ``decode_batch_flat`` of this
    same padded batch bit for bit; against the per-model sequential flush
    (a flat stream of that model's records only) the reset constants
    differ, so paths agree up to the flat decoder's rounding-tie contract.
    Phase seconds ("decode", "islands") add into ``phases``.  Returns
    (B, [IslandCalls per record] in batch order)."""
    B = len(batch)
    rows, lengths = _pad_small_batch(batch)
    dev = params_list[0].device
    any_dev = any(use_device_list)
    with _phase(phases, "decode"):
        paths = viterbi_onehot.decode_batch_flat_stacked(
            params_list,
            torch.from_numpy(rows).to(dev),  # uint8 upload
            torch.from_numpy(lengths).to(dev),
        )
        if any_dev:
            _sync(dev)
        else:
            paths = paths.cpu().numpy()
    parts: list = [None] * B
    with _phase(phases, "islands"):
        for m, params in enumerate(params_list):
            idx = [i for i in range(B) if owners[i] == m]
            if not idx:
                continue
            batch_m = [batch[i] for i in idx]
            if use_device_list[m]:
                sel = np.asarray(idx + [idx[0]] * (_round_pow2(len(idx), floor=8) - len(idx)))
                lens_m = lengths[sel].copy()
                lens_m[len(idx):] = 0
                calls_m = _batched_device_calls(
                    params, paths[m][torch.from_numpy(sel).to(dev)], rows[sel], lens_m, batch_m,
                    island_states=island_states_list[m], min_len=min_len,
                    cap_box=cap_boxes[m])
            else:
                # One batched fetch of the model's rows, not one per record.
                pm = (paths[m][torch.from_numpy(np.asarray(idx)).to(dev)].cpu().numpy()
                      if any_dev else paths[m][np.asarray(idx)])
                calls_m = [
                    _record_calls(pm[k, : symbols.size], symbols,
                                  island_states=island_states_list[m], min_len=min_len,
                                  use_device=False, cap_box=cap_boxes[m]).with_names(name or ".")
                    for k, (name, symbols) in enumerate(batch_m)
                ]
            for k, i in enumerate(idx):
                parts[i] = calls_m[k]
    return B, parts


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
    state_path_out: Optional[str] = None,
    compat: bool = True,
    chunk_size: int = chunking.DECODE_CHUNK,
    device_batch: int = 8,
    min_len: Optional[int] = None,
    span: int = CLEAN_DECODE_SPAN,
    engine: str = "auto",
    island_states=None,
    island_engine: str = "auto",
    island_cap: Optional[int] = None,
    symbol_cache: Optional[str] = None,
    invalid_symbols: str = "skip",
    device="cuda",
) -> DecodeResult:
    """Viterbi-decode a sequence file and call CpG islands.

    ``device`` (default "cuda"): where the decode runs; the model moves
    there.  compat mode decodes ``chunk_size`` chunks independently, in
    batches of ``device_batch``; clean mode decodes each FASTA record
    exactly and batches records of at most SMALL_RECORD_MAX symbols
    ``device_batch`` at a time.  ``invalid_symbols`` is the codec's
    skip/mask/fail policy (clean mode only); under 'mask' a record may
    start with PAD, and the reduced engine then hands it to a dense one.

    ``engine``: auto|xla|pallas|onehot (parallel.decode.resolve_engine).
    ``island_states`` (clean mode only): call islands with membership from
    the path and composition from the observations (e.g.
    presets.two_state_cpg with island_states=(0,)).  ``island_engine``:
    "device" calls islands where the path lies (ops.islands_device; only
    the compact call counts cross to the host), "host" on the host, "auto"
    on the card in clean mode without a state-path dump.  ``island_cap``:
    the device engine's initial output size in calls; an overflow regrows
    it and re-runs only the calling pass.

    Clean mode decodes a record of at most ``span`` symbols in one pass and
    a longer one span by span with exact boundary messages threaded between
    the spans (``viterbi_sharded_spans``): the result equals the one-pass
    decode, and the span only bounds device memory.  ``state_path_out``
    (clean mode; compat writes none, as in the JAX package) streams every
    record's decoded state path, int8, in file order to one .npy file.
    ``symbol_cache``: a symbol cache prefix (``utils.codec``; clean mode):
    built on first use, read without a parse after it."""
    if island_states is not None and compat:
        raise ValueError("island_states needs clean mode (compat=False); the "
                         "reference caller is 8-state-specific")
    _check_symbol_cache(symbol_cache, compat)
    _check_invalid_symbols(invalid_symbols, compat)
    err = island_layout_error(params, island_states)
    if err:
        raise ValueError(err)
    dev = resolve_device(device)
    params = params.to(dev)
    eng = resolve_engine(engine, params)
    # Whole records split over every local card (one entry on the CPU), as
    # the JAX package's default mesh takes every device.
    mesh = make_mesh(axis=SEQ_AXIS, device=dev)
    use_device, cap_box = _resolve_island_engine(
        island_engine, dev=dev, device_eligible=not compat and state_path_out is None,
        island_cap=island_cap,
        ineligible_msg="island_engine='device' implements clean-mode calling without a "
        "state-path dump (compat quirk reproduction and path dumps are host-side)",
    )
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
                batch_paths = batch_paths.cpu().numpy()
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

    # Clean path: one exact decode per FASTA record (span-wise past
    # ``span``), islands per record with per-record 1-based coordinates (an
    # island never spans two records).
    parts = []
    n_sym = 0
    n_records = 0
    n_spans_total = 0
    path_writer = None

    def decode_one(rec_name: str, symbols: np.ndarray) -> None:
        nonlocal n_spans_total
        n_spans = max(1, -(-symbols.size // span))
        n_spans_total += n_spans
        if n_spans > 1:
            log.info(
                "record %r (%d symbols) exceeds the single-pass decode span (%d); "
                "decoding %d spans with boundary messages threaded between them",
                rec_name, symbols.size, span, n_spans,
            )
        with _phase(phases, "decode"):
            if symbols.size == 0:
                full = np.zeros(0, dtype=np.int32)
            elif n_spans > 1:
                pieces = viterbi_sharded_spans(params, symbols, span=span, engine=eng,
                                               mesh=mesh, return_device=use_device)
                # Device islands: the span paths join on the card.
                full = torch.cat(pieces) if use_device else np.concatenate(pieces)
            else:
                full = viterbi_sharded(params, symbols, engine=eng, mesh=mesh,
                                       return_device=use_device)
            _sync(dev)
        with _phase(phases, "islands"):
            if symbols.size == 0:
                calls = islands_mod.call_islands(full, chunk=0, compat=False)
            else:
                calls = _record_calls(full, symbols, island_states=island_states,
                                      min_len=min_len, use_device=use_device, cap_box=cap_box)
        # "." = headerless leading sequence (keeps the name column parseable).
        parts.append(calls.with_names(rec_name or "."))
        if path_writer is not None:
            path_writer.write(np.asarray(full).astype(np.int8))

    def flush_small(batch: list) -> None:
        nonlocal n_spans_total
        if not batch:
            return
        if len(batch) == 1:
            decode_one(*batch[0])
            return
        batch_parts, batch_paths = _decode_small_batch(
            params, batch, engine=eng, min_len=min_len, island_states=island_states,
            use_device=use_device, cap_box=cap_box, phases=phases,
            want_paths=path_writer is not None)
        n_spans_total += len(batch)
        parts.extend(batch_parts)
        for p in batch_paths:
            path_writer.write(p)

    records = codec.iter_fasta_records_cached(test_path, symbol_cache, invalid=invalid_symbols)
    pending: list = []
    try:
        if state_path_out is not None:
            path_writer = NpyStreamWriter(state_path_out, np.int8)
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
    finally:
        # A failure mid-file still leaves a loadable (partial) dump.
        if path_writer is not None:
            path_writer.close()
    calls = IslandCalls.concatenate(parts)
    if n_records <= 1:
        # Single-record files keep the reference's bare 5-column format.
        calls = dataclasses.replace(calls, names=None)
    return _finish_decode(calls, n_sym, n_spans_total, islands_out, phases)


# One posterior pass keeps a span's symbol streams and alpha/beta streams
# on the card: about 40 B/symbol on the reduced engine, 8K B/symbol for
# each dense K-state stream (64 B/symbol for alphas and betas at K = 8,
# plus the path glue).  Longer records run span by span with exact
# boundary messages threaded between the spans: the span bounds peak
# memory, not the result.
POSTERIOR_SPAN = 1 << 26

# Records at or below this size batch into one chunked-layout pass (B4,
# or B16 with B18 / B19), one record per lane (exact: each record fits its
# lane whole).
POSTERIOR_BATCH_MAX = 1 << 19


@dataclass
class PosteriorResult:
    n_symbols: int
    n_records: int
    mean_island_confidence: float
    calls: Optional[IslandCalls] = None
    # Wall seconds per phase ("encode", "posterior", "span-totals", "islands").
    phases: dict = field(default_factory=dict)


def _posterior_record_unit(params: HmmParams, symbols: np.ndarray, island_states, *,
                           engine: str, want_path: bool, placed=None,
                           return_device: bool = False, mesh=None):
    """One whole record's posterior over ``mesh`` (default: one entry on
    the params' device) -> (conf, path or None), on the host or, with
    ``return_device``, left on the device: the single-record core of
    :func:`posterior_file` and of ``family.compare``'s sequential arm.
    ``placed``: the record already on the device
    (``parallel.posterior.place_record_span`` on the same mesh, possibly
    padded), which compare shares between the scoring pass and an order's
    members.  The lane path ("xla") pads a record it places to a power of
    two (floor 16 Ki), the JAX package's lane geometry."""
    if placed is None and engine == "xla":
        placed = post.place_record_span(params, symbols, mesh=mesh,
                                        pad_to=_round_pow2(symbols.size, floor=1 << 14))
    return post.posterior_sharded(params, symbols, island_states, engine=engine,
                                  want_path=want_path, placed=placed, mesh=mesh,
                                  return_device=return_device)


def _thread_spans(params: HmmParams, first_sym: int, totals: list):
    """Entering-alpha and exiting-beta directions of each span of a record
    from the spans' float32 [K, K] transfer operators, threaded on the host
    as the JAX package threads them (``cpgisland_tpu/pipeline.py``): the
    init direction from float64 ``pi * B[:, first]``, then every product
    and normalization in float32.  Returns (enters, exits): enters[0] is
    the record's init direction, exits[-1] None (a free end)."""
    K, S = params.n_states, params.n_symbols
    pi = np.exp(params.log_pi.cpu().numpy().astype(np.float64))
    B = np.exp(params.log_B.cpu().numpy().astype(np.float64))
    # The first emission folds in only for a real first symbol.
    v = pi * B[:, first_sym] if first_sym < S else pi
    enters = [(v / v.sum()).astype(np.float32)]
    for tot in totals[:-1]:
        v = enters[-1] @ tot
        enters.append((v / v.sum()).astype(np.float32))
    exits: list = [None] * len(totals)
    e = np.full(K, 1.0 / K, np.float32)
    for s in range(len(totals) - 2, -1, -1):
        e = totals[s + 1] @ e
        e = (e / e.sum()).astype(np.float32)
        exits[s] = e
    return enters, exits


def posterior_file(
    test_path: str,
    params: HmmParams,
    *,
    confidence_out: Optional[str] = None,
    mpm_path_out: Optional[str] = None,
    islands_out: Optional[Union[str, IO[str]]] = None,
    min_len: Optional[int] = None,
    island_states=None,
    span: int = POSTERIOR_SPAN,
    engine: str = "auto",
    island_engine: str = "auto",
    island_cap: Optional[int] = None,
    symbol_cache: Optional[str] = None,
    prefetch: int = 0,
    integrity_check: bool = False,
    resume: bool = False,
    manifest_path: Optional[str] = None,
    metrics=None,
    session=None,
    invalid_symbols: str = "skip",
    device="cuda",
) -> PosteriorResult:
    """Soft decoding of a FASTA file: per-position island confidence.

    P(position in an island | whole record) is the posterior mass on the
    island states, written as one float32 per symbol (a streamed .npy) to
    ``confidence_out``.  ``mpm_path_out`` writes the max-posterior-marginal
    state path (int8 .npy); ``islands_out`` calls CpG islands from that
    path over each whole record (clean semantics, the ``beg end len gc oe``
    format of :func:`decode_file`, a name column when the file has several
    records), with ``min_len``.  At least one output is required.

    ``island_states``: which states count as island (default: the first
    n_symbols states, the reference's X+/X- labeling, which the model must
    then have; given explicitly, islands are called from the observations'
    composition).  Records up to ``span`` symbols run in one pass; longer
    ones run span by span with exact boundary messages threaded between
    the spans; on the kernel engines records up to min(span,
    POSTERIOR_BATCH_MAX) batch together, one per lane, by power-of-two size
    class (file order kept).  ``engine``: auto|xla|pallas|onehot
    (``parallel.posterior.resolve_fb_engine``: auto takes the reduced
    kernels for the flagship's family, the dense ones for any other model
    with K <= 8, else "xla", the generic lane path, any K).  A run without
    a path output (confidence only) takes the dense engine's
    confidence-emitting backward (B19).  Runs on ``device`` (default
    "cuda"); whole records and spans split over every local card of a
    "cuda" device (``parallel.mesh.make_mesh``).

    ``island_engine`` / ``island_cap``: as in :func:`decode_file`.
    "device" reduces the MPM path to compact call records where it lies
    (one record, the small-record batch in one call per pass, a
    span-threaded record's spans joined on the device); it needs
    ``islands_out`` and no ``mpm_path_out`` (the path dump is host-side).
    "auto" takes it on the card when eligible.  An island-only run then
    sums the confidence on the device and moves one scalar to the host.
    ``symbol_cache``: as in :func:`decode_file`.  The prefetching executor,
    resume manifests, integrity checks, metrics and sessions are not ported
    and raise NotImplementedError."""
    for requested, what in (
        (prefetch > 0, "the prefetching record executor (ROADMAP A12)"),
        (resume or manifest_path is not None, "resume manifests (ROADMAP A12)"),
        (integrity_check, "integrity checks (ROADMAP A12)"),
        (metrics is not None, "metrics logging (ROADMAP A12)"),
        (session is not None, "serving sessions (ROADMAP A13)"),
    ):
        if requested:
            raise NotImplementedError(f"posterior_file: {what} not ported yet")
    obs_based_calls = island_states is not None
    if island_states is None:
        if params.n_states != 2 * params.n_symbols:
            raise ValueError(
                f"island confidence: model has {params.n_states} states / "
                f"{params.n_symbols} symbols, not the 2M-state X+/X- labeling the "
                "built-in island caller assumes; pass island_states=(...)"
            )
        island_states = tuple(range(params.n_symbols))
    island_states = tuple(sorted(island_states))
    _check_invalid_symbols(invalid_symbols, compat=False)
    want_conf = confidence_out is not None
    want_islands = islands_out is not None
    want_path = mpm_path_out is not None or want_islands
    if not (want_conf or want_path):
        raise ValueError("posterior: nothing to do — request confidence_out, "
                         "mpm_path_out, and/or islands_out")
    if span <= 0:
        raise ValueError(f"span must be positive, got {span}")
    dev = resolve_device(device)
    params = params.to(dev)
    eng = post.resolve_fb_engine(engine, params)
    mesh = make_mesh(axis=SEQ_AXIS, device=dev)
    # The small-record batch runs the kernels' chunked layout; the lane path
    # takes every record whole, as in the JAX package.
    batch_small = eng != "xla"
    use_device, cap_box = _resolve_island_engine(
        island_engine, dev=dev, device_eligible=want_islands and mpm_path_out is None,
        island_cap=island_cap,
        ineligible_msg="island_engine='device' reduces the MPM path on device — it "
        "needs islands_out and no mpm_path_out (the path dump is host-side)",
    )
    mask = post.island_mask(params, island_states)
    S = params.n_symbols
    phases: dict = {}
    call_parts: list = []
    conf_w = path_w = None
    n_sym = n_records = 0
    conf_total = 0.0
    conf_dev_acc = None  # float32 running sum on the device (island-only runs)

    def emit(conf, path) -> None:
        """Book one piece's outputs: host arrays, or with the device island
        engine a device confidence (the path stays there for the caller)."""
        nonlocal conf_total, conf_dev_acc
        if isinstance(conf, torch.Tensor):
            if not want_conf:
                # Summed where it lies: one scalar crosses at the end of the file.
                s = torch.sum(conf)
                conf_dev_acc = s if conf_dev_acc is None else conf_dev_acc + s
                return
            conf = conf.cpu().numpy()
        # float64 sum: float32 partials drift ~1e-5 at multi-Gbase.
        conf_total += float(conf.sum(dtype=np.float64))
        if conf_w is not None:
            conf_w.write(conf)
        if path_w is not None:
            path_w.write(path)

    def call_rec(name: str, symbols: np.ndarray, path) -> None:
        if not want_islands:
            return
        with _phase(phases, "islands"):
            calls = _record_calls(path, symbols,
                                  island_states=island_states if obs_based_calls else None,
                                  min_len=min_len, use_device=use_device, cap_box=cap_box)
        call_parts.append(calls.with_names(name or "."))

    def one_record(name: str, symbols: np.ndarray) -> None:
        with _phase(phases, "posterior"):
            conf, path = _posterior_record_unit(params, symbols, island_states, engine=eng,
                                                want_path=want_path, return_device=use_device,
                                                mesh=mesh)
            _sync(dev)
        emit(conf, path)
        call_rec(name, symbols, path)

    def flush_small(batch: list) -> None:
        if len(batch) <= 1:
            for rec in batch:
                one_record(*rec)
            return
        # One pass per power-of-two size class: padding every record to the
        # batch maximum would multiply the work by the size spread.  Results
        # go out in file order.
        by_class: dict = {}
        for i, (_, s) in enumerate(batch):
            by_class.setdefault(_round_pow2(s.size, floor=1 << 14), []).append(i)
        results: list = [None] * len(batch)  # (conf, path) per record, host arrays
        rec_calls: list = [None] * len(batch)  # the device engine's calls per record
        # Device memory per pass, in padded symbols: want_path keeps both
        # reduced streams, so it gets half.
        budget = (1 << 26) // (2 if want_path else 1)
        for Tpad in sorted(by_class):
            group_all = by_class[Tpad]
            max_rows = max(1, budget // Tpad)
            for lo in range(0, len(group_all), max_rows):
                group = group_all[lo : lo + max_rows]
                rows = np.full((_round_pow2(len(group), floor=8), Tpad), chunking.PAD_SYMBOL,
                               np.uint8)
                lens = np.zeros(rows.shape[0], np.int32)
                for g, i in enumerate(group):
                    s = batch[i][1]
                    rows[g, : s.size] = s
                    lens[g] = s.size
                with _phase(phases, "posterior"):
                    conf2, path2 = fb_seq.batch_posterior(
                        params, torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev),
                        mask, want_path=want_path, engine=eng,
                    )
                    if use_device:
                        _sync(dev)
                    else:
                        conf2 = conf2.cpu().numpy()
                        path2 = path2.to(torch.int8).cpu().numpy() if want_path else None
                if use_device:
                    # One device island call for the pass; padded tails and
                    # rows are masked out of the confidence sum.
                    with _phase(phases, "islands"):
                        g_calls = _batched_device_calls(
                            params, path2, rows, lens, [batch[i] for i in group],
                            island_states=island_states if obs_based_calls else None,
                            min_len=min_len, cap_box=cap_box)
                    if want_conf:
                        conf2 = conf2.cpu().numpy()
                    else:
                        in_rec = (torch.arange(Tpad, device=dev)[None, :]
                                  < torch.from_numpy(lens).to(dev)[:, None])
                        emit(torch.where(in_rec, conf2, 0.0), None)
                for g, i in enumerate(group):
                    n = batch[i][1].size
                    if use_device:
                        rec_calls[i] = g_calls[g]
                        results[i] = (conf2[g, :n] if want_conf else None, None)
                    else:
                        results[i] = (conf2[g, :n], path2[g, :n] if want_path else None)
        for i, ((name, s), (conf, path)) in enumerate(zip(batch, results)):
            if conf is not None:
                emit(conf, path)
            if use_device:
                call_parts.append(rec_calls[i])
            else:
                call_rec(name, s, path)

    def spanned_record(name: str, symbols: np.ndarray) -> None:
        # Sweep A: each span's [K, K] transfer operator (B7 or B17 only).
        # Each span is uploaded and prepared once, for both sweeps; only the
        # reduced engine reads the symbol before a span.
        starts = range(0, symbols.size, span)
        prevs = [0 if lo == 0 else _prev_real_symbol(symbols, lo, S) for lo in starts]
        placed, preps, span_totals = [], [], []
        # The lane path pads every span to the span size (the JAX package's
        # geometry); the kernels take the span as it is.
        pad_to = span if eng == "xla" else None
        with _phase(phases, "span-totals"):
            for lo, prev in zip(starts, prevs):
                piece = symbols[lo : lo + span]
                placed.append(post.place_record_span(params, piece, mesh=mesh, pad_to=pad_to))
                preps.append(post.prepare_record_span(params, placed[-1], piece.size, engine=eng,
                                                      first=lo == 0, prev_sym=prev, mesh=mesh))
                span_totals.append(post.transfer_total_sharded(
                    params, piece, engine=eng, first=lo == 0, placed=placed[-1],
                    prev_sym=prev, prepared=preps[-1], mesh=mesh))
        enters, exits = _thread_spans(params, int(symbols[0]), span_totals)
        # Sweep B: each span's posterior with the threaded messages.
        paths = []
        for s, (lo, prev) in enumerate(zip(starts, prevs)):
            piece = symbols[lo : lo + span]
            with _phase(phases, "posterior"):
                conf, path = post.posterior_sharded(
                    params, piece, island_states, engine=eng,
                    enter_dir=None if s == 0 else enters[s], exit_dir=exits[s], first=s == 0,
                    want_path=want_path, placed=placed[s], prev_sym=prev, prepared=preps[s],
                    return_device=use_device, mesh=mesh,
                )
                _sync(dev)
            placed[s] = preps[s] = None  # release the span's device memory
            emit(conf, path)
            paths.append(path)
        if want_islands:
            # Over the WHOLE record's path (joined on the device with the
            # device engine), so no island is clipped at a span boundary.
            call_rec(name, symbols, torch.cat(paths) if use_device else np.concatenate(paths))

    records = codec.iter_fasta_records_cached(test_path, symbol_cache, invalid=invalid_symbols)
    pending: list = []
    try:
        if want_conf:
            conf_w = NpyStreamWriter(confidence_out, np.float32)
        if mpm_path_out is not None:
            path_w = NpyStreamWriter(mpm_path_out, np.int8)
        while True:
            with _phase(phases, "encode"):
                rec = next(records, None)
            if rec is None:
                break
            name, symbols = rec
            n_records += 1
            n_sym += symbols.size
            if symbols.size == 0:
                continue
            # A record the span would split takes the span path, never the batch.
            if batch_small and symbols.size <= min(span, POSTERIOR_BATCH_MAX):
                pending.append((name, symbols))
                if len(pending) >= 128:
                    flush_small(pending)
                    pending = []
                continue
            flush_small(pending)  # keep file order around a large record
            pending = []
            if symbols.size <= span:
                one_record(name, symbols)
            else:
                spanned_record(name, symbols)
        flush_small(pending)
    finally:
        for w in (conf_w, path_w):
            if w is not None:
                w.close()
    if conf_dev_acc is not None:
        conf_total += float(conf_dev_acc)  # the one end-of-file scalar fetch
    calls_all = None
    if want_islands:
        calls_all = IslandCalls.concatenate(call_parts)
        if n_records <= 1:
            # Single-record files keep the reference's bare 5-column format.
            calls_all = dataclasses.replace(calls_all, names=None)
        _write_calls(calls_all, islands_out)
    return PosteriorResult(
        n_symbols=int(n_sym), n_records=n_records,
        mean_island_confidence=conf_total / n_sym if n_sym else 0.0,
        calls=calls_all, phases=phases,
    )


@dataclass
class CompareResult:
    n_symbols: int
    n_records: int
    member_names: list
    baseline: str
    records: list  # [family.RecordComparison] in file order
    # Wall seconds per phase ("encode" — the FASTA parse and each order's
    # stream —, "score", "posterior", "islands", "winner").
    phases: dict = field(default_factory=dict)


def compare_file(
    test_path: str,
    members=None,
    *,
    out: Optional[Union[str, IO[str]]] = None,
    engine: str = "auto",
    baseline: Optional[str] = None,
    min_len: Optional[int] = None,
    threshold: Optional[float] = None,
    symbol_cache: Optional[str] = None,
    invalid_symbols: str = "skip",
    metrics=None,
    timer=None,
    sessions=None,
    stacked: bool = True,
    device="cuda",
) -> CompareResult:
    """Multi-model posterior comparison over a FASTA file (clean semantics,
    per record): the CLI's ``compare``.

    Every member is evaluated over the same record stream (order-2 members
    over its pair recode) through ``family.compare_record`` on ``device``
    (default "cuda"): per member the record loglik, the log-odds against
    ``baseline`` and the island calls from its MPM path, and the
    per-position winner track.  ``out`` (path or open file) gets the
    report: a ``# cpgisland compare`` header, then per record a ``# record``
    line, one ``# model`` line per member (loglik, log-odds, island count)
    and the winner track as reference-format island lines named
    ``<record>|<member>`` (bare ``<member>`` in single-record files).

    ``members`` defaults to the 3-model cast (durbin8, two_state, null).
    ``stacked`` (default) groups same-order reduced members into one
    stacked launch set per record; the results are bit-identical either
    way.  ``symbol_cache``: as in :func:`decode_file`.  Metrics and phase
    timers (ROADMAP A12) and serving sessions (A13) are not ported and raise
    NotImplementedError."""
    from cpgisland_tpu_torch import family

    for requested, what in (
        (metrics is not None, "metrics logging (ROADMAP A12)"),
        (timer is not None, "phase timers (ROADMAP A12)"),
        (sessions is not None, "serving sessions (ROADMAP A13)"),
    ):
        if requested:
            raise NotImplementedError(f"compare_file: {what} not ported yet")
    if members is None:
        members = family.default_members()
    names = [m.name for m in members]
    kw = {} if threshold is None else {"threshold": threshold}
    b_idx = family.resolve_baseline(members, baseline)
    _check_invalid_symbols(invalid_symbols, compat=False)
    dev = resolve_device(device)
    phases: dict = {}
    records: list = []
    n_sym = 0
    rec_iter = codec.iter_fasta_records_cached(test_path, symbol_cache, invalid=invalid_symbols)
    while True:
        with _phase(phases, "encode"):
            rec = next(rec_iter, None)
        if rec is None:
            break
        rec_name, symbols = rec
        n_sym += symbols.size
        records.append(family.compare_record(
            members, symbols, record=rec_name or ".", engine=engine,
            baseline=members[b_idx].name, min_len=min_len, stacked=stacked, device=dev,
            phases=phases, **kw,
        ))
    if out is not None:
        _write_compare(records, names, members[b_idx].name, out)
    return CompareResult(n_symbols=n_sym, n_records=len(records), member_names=names,
                         baseline=members[b_idx].name, records=records, phases=phases)


def _write_compare(records, names, baseline: str, out) -> None:
    """The compare report writer (see :func:`compare_file`'s format)."""
    own = isinstance(out, str)
    f = open(out, "w") if own else out
    try:
        f.write(f"# cpgisland compare models={','.join(names)} baseline={baseline}\n")
        multi = len(records) > 1
        for rc in records:
            f.write(f"# record {rc.record} symbols {rc.n_symbols}\n")
            for m in rc.members:
                f.write(f"# model {m.name} loglik {m.loglik:.6f} "
                        f"log_odds {m.log_odds:.6f} islands {len(m.calls)}\n")
            wc = rc.winner_calls
            if multi and wc.names is not None:
                wc = dataclasses.replace(
                    wc, names=np.array([f"{rc.record}|{n}" for n in wc.names], dtype=object))
            f.write(wc.format_lines())
    finally:
        if own:
            f.close()


def _train_input(training_path: str, params: HmmParams, backend, compat: bool,
                 chunk_size: int, symbol_cache: Optional[str], invalid_symbols: str):
    """train_file's input: whole FASTA records in power-of-two buckets for
    ``backend="seq2d"`` (clean mode only: compat mode has no records),
    else the reference's chunk framing."""
    if backend == "seq2d":
        if compat:
            raise ValueError(
                "backend 'seq2d' trains per FASTA record; compat mode has no "
                "records — use compat=False (--clean)"
            )
        try:
            return chunking.bucket_records(
                (s for _, s in codec.iter_fasta_records_cached(training_path, symbol_cache,
                                                                invalid=invalid_symbols)),
                pad_value=params.n_symbols,
            )
        except ValueError:
            raise ValueError(f"no sequence records in {training_path}")
    symbols = codec.encode_file_cached(training_path, symbol_cache, skip_headers=not compat,
                                       invalid=invalid_symbols)
    return chunking.frame(symbols, chunk_size, drop_remainder=compat)


def train_file(
    training_path: str,
    *,
    params: Optional[HmmParams] = None,
    num_iters: int = 10,
    convergence: float = 0.005,
    backend="local",
    mode: str = "rescaled",
    engine: str = "auto",
    compat: bool = True,
    chunk_size: int = chunking.TRAIN_CHUNK,
    model_out: Optional[str] = None,
    symbol_cache: Optional[str] = None,
    invalid_symbols: str = "skip",
    fuse: Union[bool, str] = "auto",
    device="cuda",
) -> baum_welch.FitResult:
    """Train the CpG HMM on a sequence file (the reference's ``trainModel``).

    ``params`` (default: the Durbin 8-state preset) moves to ``device``
    (default "cuda").  ``backend``: a name or a backend instance
    (``train.backends``): "local" trains on the reference's chunk framing;
    "spmd" on the same chunks split over a mesh's data axis; "seq" on the
    whole input as ONE sequence; "seq2d" on every FASTA record as its own
    whole sequence (clean mode only); the mesh backends' default mesh
    takes every local card of a "cuda" device (one entry on the CPU).
    ``engine``: auto|xla|pallas|onehot (``train.backends``: auto takes the
    reduced kernels for the flagship's family, the dense ones for any
    other model with K <= 8, else the generic "xla" engine, which
    ``mode="log"`` also takes; on the whole-sequence backends "xla" is the
    lane path of ``parallel.fb_sharded``).  ``mode``: the numerics,
    "rescaled" or "log".
    ``fuse``: the EM
    loop, on the device ("auto", "on") or on the host ("off").  compat mode
    encodes header lines as bases and drops the remainder chunk, so it
    trains nothing on a file below ``chunk_size`` symbols; clean mode
    parses FASTA and pads the last chunk.  ``invalid_symbols`` is the
    codec's skip/mask/fail policy (clean mode only).  ``model_out``: write
    the reference's text dump of the trained model.  ``symbol_cache``: as
    in :func:`decode_file` (clean mode; every backend's input)."""
    if params is None:
        params = presets.durbin_cpg8()
    _check_symbol_cache(symbol_cache, compat)
    _check_invalid_symbols(invalid_symbols, compat)
    dev = resolve_device(device)
    phases: dict = {}
    with _phase(phases, "encode"):
        chunked = _train_input(training_path, params, backend, compat, chunk_size,
                               symbol_cache, invalid_symbols)
    if isinstance(backend, str):
        backend = baum_welch.get_backend(backend, mode=mode, engine=engine)
    if hasattr(backend, "bind"):
        # A mesh backend's default mesh takes every local card of "cuda"
        # (fit would bind it to the model's one card).
        backend.bind(dev)
    result = baum_welch.fit(
        params.to(dev), chunked, num_iters=num_iters, convergence=convergence,
        backend=backend, mode=mode, engine=engine, fuse=fuse,
    )
    result.phases.update(phases)
    if model_out is not None:
        dump_text(result.params, model_out)
    return result


def run(
    training_path: str,
    test_path: str,
    islands_out: str,
    model_out: str,
    convergence: float = 0.005,
    num_iters: int = 10,
    *,
    params: Optional[HmmParams] = None,
    backend="local",
    mode: str = "rescaled",
    compat: bool = True,
    checkpoint_dir: Optional[str] = None,
    min_len: Optional[int] = None,
    engine: str = "auto",
    island_states=None,
    symbol_cache: Optional[str] = None,
    fuse: Union[bool, str] = "auto",
    prefetch: int = 0,
    device="cuda",
) -> DecodeResult:
    """The reference's full ``main()``: train, dump the model, decode,
    write islands (CpGIslandFinder.java:346-357).  ``params`` is the initial
    model (default: the Durbin preset); ``engine``, ``min_len`` and
    ``island_states`` go to the decode, as in the JAX package; training
    takes its own "auto" engine, ``backend``, ``mode`` and ``fuse``
    (:func:`train_file`); ``symbol_cache`` serves both files (clean mode).
    Checkpoints and the prefetching executor (ROADMAP A12) raise
    NotImplementedError."""
    for requested, what in ((checkpoint_dir is not None, "checkpoints (ROADMAP A12)"),
                            (prefetch > 0, "the prefetching record executor (ROADMAP A12)")):
        if requested:
            raise NotImplementedError(f"run: {what} not ported yet")
    fit = train_file(training_path, params=params, num_iters=num_iters,
                     convergence=convergence, model_out=model_out, compat=compat,
                     backend=backend, mode=mode, symbol_cache=symbol_cache, fuse=fuse,
                     device=device)
    return decode_file(test_path, fit.params, islands_out=islands_out, compat=compat,
                       min_len=min_len, engine=engine, island_states=island_states,
                       symbol_cache=symbol_cache, device=device)
