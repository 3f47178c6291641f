"""E-step execution backends behind the reference's mapper/reducer contract.

Counterpart of ``cpgisland_tpu/train/backends.py``, cut to one device, on
the reduced (one-hot) and dense ("pallas") kernel engines and the generic
"xla" engine (``ops.forward_backward``: any model, both numerics), which
the chunked backends take wherever the JAX router does.  The reference
trains by one MR job per EM iteration: mappers run forward-backward over
65,536-symbol chunks and emit expected counts, the reduce sums them
(CpGIslandFinder.java:200-201).  :class:`LocalBackend` keeps that framing:
the chunk batch is one tensor on the card, every chunk one lane of the
E-step kernels, and the reduce a sum over lanes.  The whole-sequence
backends drop the chunk-independence approximation:
:class:`SeqBackend` trains on the whole input as ONE sequence and
:class:`Seq2DBackend` on every FASTA record as its own whole sequence
(``ops.fb_seq.seq_stats``: exact boundary messages between lanes).
:class:`FamilyEStep` and :func:`fit_family` train M reduced members of one
alphabet in lockstep through the stacked kernels.

Every backend has ``prepare(chunked)`` (the input layout, on the host),
``place`` (one upload per fit), ``prepare_streams`` (the symbol-only prep,
once per fit) and ``__call__(params, chunks, lengths, prepared=)`` (one
E-step).  Meshes and more than one device (``spmd``, a ``mesh``) wait for
ROADMAP A9.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cpgisland_tpu_torch.family import partition as family_partition
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import fb_chunked, fb_onehot, fb_pallas, fb_seq, forward_backward
from cpgisland_tpu_torch.ops import prepared as prep_mod
from cpgisland_tpu_torch.ops.forward_backward import SuffStats
from cpgisland_tpu_torch.ops.prepared import PreparedChunked, prepare_chunked, prepare_seq
from cpgisland_tpu_torch.parallel import fb_sharded
from cpgisland_tpu_torch.utils import chunking

# The reduced chains are K-free; the [K*K] stats accumulators bound K
# (the JAX package's ONEHOT_MAX_STATES).
ONEHOT_MAX_STATES = 32


def resolve_fb_engine(engine: str, params: HmmParams, mode: str) -> str:
    """The E-step engine for ``params``, as the JAX router picks it on its
    TPU: "auto" with the rescaled numerics takes "onehot" for a model with
    reduced-stats-eligible emissions (one-hot states in groups of 2,
    power-of-two alphabet) and K <= ONEHOT_MAX_STATES, else "pallas" (the
    dense kernels) where ``fb_pallas.supports`` the model (K <= 8), else
    "xla", the generic engine (``ops.forward_backward.batch_stats``); with
    ``mode="log"`` it takes "xla", the one engine with the log numerics.
    An explicit engine is honoured where it fits: "pallas" and "onehot"
    implement the rescaled numerics only."""
    if engine not in ("auto", "xla", "pallas", "onehot"):
        raise ValueError(f"unknown engine {engine!r}; expected auto|xla|pallas|onehot")
    if mode not in ("rescaled", "log"):
        raise ValueError(f"unknown numerics mode: {mode!r}")
    onehot_ok = (params.n_states <= ONEHOT_MAX_STATES
                 and family_partition.reduced_stats_eligible(params))
    if engine == "auto":
        if mode == "rescaled" and onehot_ok:
            return "onehot"
        if mode == "rescaled" and fb_pallas.supports(params):
            return "pallas"
        return "xla"
    if engine in ("pallas", "onehot") and mode != "rescaled":
        raise ValueError(f"{engine} E-step implements rescaled numerics only")
    if engine == "pallas" and not fb_pallas.supports(params):
        raise ValueError(
            f"pallas E-step kernels need n_states <= {fb_pallas.MAX_STATES} and "
            f"n_symbols <= {fb_pallas.MAX_SYMBOLS}, got {params.n_states} / "
            f"{params.n_symbols}"
        )
    if engine == "onehot" and not onehot_ok:
        raise ValueError(
            "engine='onehot' needs emissions one-hot in groups of 2 over a "
            f"power-of-two alphabet and at most {ONEHOT_MAX_STATES} states"
        )
    return engine


class LocalBackend:
    """One device: the chunk batch is placed and its symbol streams are
    prepared once per fit; each call is one E-step over all chunks on the
    engine resolved in :meth:`prepare_streams` (:func:`resolve_fb_engine`;
    "xla" runs ``forward_backward.batch_stats`` in ``mode``).

    ``fuse_fb=False`` runs the reduced engine's split arm (B9, B10, B12 in
    place of B4 and B5), the JAX package's A/B baseline; its ``None``
    default reads the JAX tuner table, which the port does not have
    (ROADMAP A14): here ``None`` means True, the shipped default."""

    def __init__(self, mode: str = "rescaled", engine: str = "auto",
                 fuse_fb: Optional[bool] = None):
        self.mode = mode
        self.engine = engine
        self.fuse_fb = True if fuse_fb is None else bool(fuse_fb)
        self.resolved: Optional[str] = None

    def prepare(self, chunked: chunking.Chunked) -> chunking.Chunked:
        """The chunk batch as it is (a Bucketed batch is Seq2DBackend's)."""
        _reject_bucketed(self, chunked)
        return chunked

    def place(self, chunked: chunking.Chunked, device) -> tuple:
        """Upload the uint8 chunks and their lengths once, before the loop."""
        chunks = chunking.upload(chunked.chunks, device)
        lengths = chunking.upload(chunked.lengths, device)
        return chunks, lengths

    def prepare_streams(self, params: HmmParams, chunks: torch.Tensor,
                        lengths: torch.Tensor) -> Optional[PreparedChunked]:
        """The symbol-only prep of the placed batch (built on its device;
        None for the generic engine, which reads the chunks as they are).
        The engine resolves here, once per fit: it reads the emission
        structure on the host, and EM keeps that structure (structural
        zeros are fixed points), so the iterations need not re-resolve."""
        self.resolved = resolve_fb_engine(self.engine, params, self.mode)
        if self.resolved == "xla":
            return None
        return prepare_chunked(params.n_symbols, chunks, lengths,
                               t_tile=fb_chunked.DEFAULT_T_TILE,
                               onehot=self.resolved == "onehot")

    def __call__(self, params: HmmParams, chunks: torch.Tensor, lengths: torch.Tensor,
                 prepared: Optional[PreparedChunked]) -> SuffStats:
        if self.resolved is None:
            raise RuntimeError("LocalBackend: call prepare_streams before the E-step")
        if self.resolved == "xla":
            return forward_backward.batch_stats(params, chunks, lengths, mode=self.mode)
        return fb_chunked.batch_stats(params, chunks, lengths, prepared=prepared,
                                      engine=self.resolved, fused=self.fuse_fb)


class FamilyEStep:
    """Stacked E-step of M model-family members (reduced-stats-eligible,
    one alphabet) over ONE shared chunk batch: every member's chains in one
    launch of B24 and its counts in one of B25 (``fb_chunked.
    batch_stats_stacked``); with ``fuse_fb=False`` (the split arm) the
    chains in one launch of B22 and one of B23, the counts through B12 per
    member.  Member m's statistics equal ``LocalBackend(engine="onehot",
    fuse_fb=fuse_fb)``'s bit for bit.  ``stacked=False`` is the sequential
    arm: M single-model reduced E-steps over the same placed batch and
    prep.  The JAX package's ``None`` defaults read its tuner table, which
    the port does not have (ROADMAP A14): here ``None`` means True."""

    def __init__(self, t_tile: Optional[int] = None, fuse_fb: Optional[bool] = None,
                 stacked: Optional[bool] = None):
        self.t_tile = fb_chunked.DEFAULT_T_TILE if t_tile is None else int(t_tile)
        self.fuse_fb = True if fuse_fb is None else bool(fuse_fb)
        self.stacked = True if stacked is None else bool(stacked)

    def validate(self, params_list) -> None:
        fb_onehot.check_stacked_members(params_list)
        for p in params_list:
            if not (family_partition.reduced_stats_eligible(p)
                    and p.n_states <= ONEHOT_MAX_STATES):
                raise ValueError(
                    "FamilyEStep members must be reduced-stats-eligible (one-hot emissions "
                    "in groups of 2 over a power-of-two alphabet, at most "
                    f"{ONEHOT_MAX_STATES} states)"
                )

    def place(self, chunks, lengths, device) -> tuple:
        """The uint8 chunks and their lengths on ``device``, uploaded once."""
        return (torch.as_tensor(chunks).to(device), torch.as_tensor(lengths).to(device))

    def prepare_streams(self, params_list, chunks: torch.Tensor,
                        lengths: torch.Tensor) -> PreparedChunked:
        """ONE symbol-only prep for every member: the pair stream depends on
        the symbols and the alphabet only."""
        return prepare_chunked(params_list[0].n_symbols, chunks, lengths, t_tile=self.t_tile,
                               onehot=True)

    def __call__(self, params_list, chunks: torch.Tensor, lengths: torch.Tensor,
                 prepared: Optional[PreparedChunked] = None) -> tuple:
        params_list = tuple(params_list)
        self.validate(params_list)
        if prepared is None:
            prepared = self.prepare_streams(params_list, chunks, lengths)
        if not self.stacked:
            return tuple(fb_chunked.batch_stats(p, chunks, lengths, prepared=prepared,
                                                engine="onehot", fused=self.fuse_fb)
                         for p in params_list)
        return fb_chunked.batch_stats_stacked(params_list, chunks, lengths, prepared=prepared,
                                              fused=self.fuse_fb)


def fit_family(params_list, chunks, lengths, *, n_iter: int = 10,
               estep: Optional[FamilyEStep] = None):
    """Train M family members in LOCKSTEP over one chunk batch (``chunks``
    [N, T] uint8, ``lengths`` [N], arrays or tensors) on the first
    member's device: each iteration runs ONE stacked E-step and M M-steps.
    Member m's trajectory equals ``baum_welch.fit`` of that member alone
    (onehot engine, convergence 0) bit for bit.  No host sync inside the
    loop: the logliks come back once, after it.  Returns (trained params
    list, logliks [n_iter, M] float64)."""
    from cpgisland_tpu_torch.train.baum_welch import mstep

    estep = estep if estep is not None else FamilyEStep()
    dev = params_list[0].device
    params_list = [HmmParams(p.log_pi.float(), p.log_A.float(), p.log_B.float())
                   for p in params_list]
    chunks, lengths = estep.place(chunks, lengths, dev)
    prep = estep.prepare_streams(params_list, chunks, lengths)
    hist = []
    for _ in range(int(n_iter)):
        stats = estep(params_list, chunks, lengths, prepared=prep)
        hist.append(torch.stack([st.loglik.float() for st in stats]))
        params_list = [mstep(p, st) for p, st in zip(params_list, stats)]
    if not hist:
        return params_list, np.zeros((0, len(params_list)), np.float64)
    return params_list, torch.stack(hist).double().cpu().numpy()


_MULTI_DEVICE = "multi-device training (a mesh, backend 'spmd') is not ported yet (ROADMAP A9)"


def _reject_bucketed(backend, chunked) -> None:
    if isinstance(chunked, chunking.Bucketed):
        raise ValueError(f"{type(backend).__name__} does not support Bucketed input "
                         "(Seq2DBackend does)")


def _check_seq_engine(engine: str) -> None:
    if engine not in ("auto", "xla", "pallas", "onehot"):
        raise ValueError(f"sequence-parallel engine must be auto|xla|pallas|onehot, got {engine!r}")


# Largest record class Seq2DBackend trains as whole records, one per lane of
# the chunked kernels (exact: a record that fits a lane needs no boundary
# messages): the reference's own 64 Ki chunk.
SMALL_RECORD_ROWS_MAX = 1 << 16

# Peak device bytes per symbol of one whole-sequence E-step (seq_stats with
# its prep), the worst of three arms measured by chip_smoke.py at 16 Mi and
# 64 Mi symbols on an NVIDIA H100 80GB HBM3 at a 700 W power limit: reduced
# two-pass 45.0, one-pass 72.0, dense K = 8 270.0 (rounded up here).  The
# card's budget is (total memory - SEQ_RESERVE_BYTES) / this, floored to
# SEQ_SHARD_GRANULE: 272 Mi symbols on that card.
SEQ_BYTES_PER_SYMBOL = 271
SEQ_RESERVE_BYTES = 4 << 30
SEQ_SHARD_GRANULE = 16 << 20


def seq_shard_budget(device) -> Optional[int]:
    """Longest sequence (symbols) one whole-sequence E-step takes on
    ``device``: from the card's memory at call time; None (no budget) on
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    fit = (total - SEQ_RESERVE_BYTES) // SEQ_BYTES_PER_SYMBOL
    return max(SEQ_SHARD_GRANULE, fit // SEQ_SHARD_GRANULE * SEQ_SHARD_GRANULE)


def _check_seq_shard(shard_len: int, what: str, device) -> None:
    """Refuse a whole sequence longer than the card's budget with advice,
    before any allocation fails."""
    budget = seq_shard_budget(device)
    if budget is not None and shard_len > budget:
        alt = ("a longer chunked layout" if what == "Seq2DBackend"
               else "per-record rows with backend='seq2d'")
        raise ValueError(
            f"{what}: a whole sequence of {shard_len} symbols exceeds the "
            f"~{budget >> 20} Mi single-card whole-sequence E-step budget (measured "
            f"footprint ~{SEQ_BYTES_PER_SYMBOL} B/symbol against "
            f"~{(budget * SEQ_BYTES_PER_SYMBOL) >> 30} GiB usable device memory) — use "
            f"{alt}, or the chunked 'local' backend (the reference's own framing)"
        )


def _use_fused_seq(engine: str, params: HmmParams) -> bool:
    """Route a whole-sequence E-step to the kernels.  The JAX package takes
    its XLA lane path under a 1 Mi shard and off the TPU; that path is not
    ported (ROADMAP A2), so "auto" takes the kernels at every size, and an
    explicit "pallas" / "onehot" is validated against the model."""
    if engine == "xla":
        raise NotImplementedError(
            "the XLA lane path of the whole-sequence E-step is not ported yet (ROADMAP A2)")
    if engine == "pallas":
        if not fb_pallas.supports(params):
            raise ValueError(f"engine='pallas' but the fused kernels do not support "
                             f"{params.n_states} states")
        return True
    if engine == "onehot":
        if params.n_states > ONEHOT_MAX_STATES:
            raise ValueError(f"engine='onehot' but {params.n_states} states exceed the "
                             f"reduced envelope ({ONEHOT_MAX_STATES})")
        if not family_partition.reduced_eligible(params):
            raise ValueError("engine='onehot' needs a one-hot emission-support partition "
                             "with 2 states per symbol (family.partition_of)")
        return True
    if fb_pallas.supports(params) or _seq_onehot(engine, params):
        return True
    raise NotImplementedError(
        f"{params.n_states} states over {params.n_symbols} symbols: outside the reduced "
        "and the dense kernels' domains; the XLA lane path is not ported yet (ROADMAP A2)")


def _seq_onehot(engine: str, params: HmmParams) -> bool:
    """The reduced kernels for a whole-sequence E-step?  Explicit "onehot"
    always (validated in :func:`_use_fused_seq`); "auto" when the model's
    emission structure supports them."""
    if engine == "onehot":
        return True
    if engine == "auto":
        return (family_partition.reduced_eligible(params)
                and params.n_states <= ONEHOT_MAX_STATES
                and params.n_symbols <= fb_onehot.MAX_SYMBOLS)
    return False


def _host_lengths(lengths: torch.Tensor) -> list:
    """The placed lengths on the host, fetched once per placed tensor."""
    return prep_mod.cached_build("seq-lengths", (lengths,), (),
                                 lambda: [int(x) for x in lengths.cpu().reshape(-1)])


class SeqBackend:
    """Exact whole-sequence E-step: the ENTIRE training input is ONE
    sequence (n_seqs 1) — no 65,536-symbol independence approximation and
    no dropped boundary transition pairs, unlike the reference's chunked
    mapper contract (CpGIslandFinder.java:130-141).  Rescaled probability
    numerics; ``engine`` picks the kernels (auto / pallas / onehot; "xla"
    raises, ROADMAP A2).

    ``lane_T``: steps per lane (None: ``fb_seq.pick_lane_T``).  The JAX
    package's ``None`` defaults read its tuner table, which the port does
    not have (ROADMAP A14): here ``t_tile=None`` means
    ``fb_chunked.DEFAULT_T_TILE``, ``fuse_fb=None`` True and
    ``one_pass=None`` False — its shipped legacy defaults.
    ``fuse_fb=False`` runs the reduced engine's split chains (B9, B10 in
    place of B4; B5 stays, exact over their cs-scaled betas).
    ``one_pass=True`` runs B8 in place of B7 and B4 on the reduced engine's
    kernel-stats route (power-of-two alphabets), whatever ``fuse_fb`` says;
    elsewhere it is ignored, bit for bit.  One device only: a ``mesh``
    raises (ROADMAP A9)."""

    def __init__(self, mesh=None, block_size: Optional[int] = None,
                 pad_value: int = chunking.PAD_SYMBOL, engine: str = "auto",
                 lane_T: Optional[int] = None, t_tile: Optional[int] = None,
                 fuse_fb: Optional[bool] = None, one_pass: Optional[bool] = None):
        if mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
        _check_seq_engine(engine)
        self.block_size = fb_sharded.DEFAULT_BLOCK if block_size is None else int(block_size)
        self.pad_value = pad_value
        self.engine = engine
        self.lane_T = lane_T
        self.t_tile = fb_chunked.DEFAULT_T_TILE if t_tile is None else int(t_tile)
        self.fuse_fb = True if fuse_fb is None else bool(fuse_fb)
        self.one_pass = bool(one_pass)
        self.resolved: Optional[str] = None

    def prepare(self, chunked: chunking.Chunked) -> chunking.Chunked:
        """Re-frame any chunk batch as one stream, padded to a block
        multiple."""
        _reject_bucketed(self, chunked)
        stream = (np.concatenate([np.asarray(c[:l]) for c, l in
                                  zip(chunked.chunks, chunked.lengths)])
                  if chunked.num_chunks else np.zeros(0, np.uint8))
        obs_p, lengths = fb_sharded.shard_sequence(stream, 1, self.block_size,
                                                   pad_value=self.pad_value)
        return chunking.Chunked(chunks=obs_p.reshape(1, -1), lengths=lengths,
                                total=int(stream.shape[0]))

    def place(self, chunked: chunking.Chunked, device) -> tuple:
        """The flat stream [L] and its length [1], uploaded once."""
        return (torch.from_numpy(np.ascontiguousarray(chunked.chunks).reshape(-1)).to(device),
                torch.from_numpy(np.asarray(chunked.lengths)).to(device))

    def _geometry(self, params: HmmParams, obs_flat: torch.Tensor):
        """(engine, lane_T) of a placed stream: the one routing point."""
        if obs_flat.dim() != 1:
            raise ValueError(f"SeqBackend expects a flat placed [L] stream, got shape "
                             f"{tuple(obs_flat.shape)}; run prepare() + place() first")
        if obs_flat.shape[0] % self.block_size:
            raise ValueError(f"stream length {obs_flat.shape[0]} not a multiple of "
                             f"block_size = {self.block_size}; run prepare() first")
        _check_seq_shard(obs_flat.shape[0], "SeqBackend", obs_flat.device)
        _use_fused_seq(self.engine, params)
        eng = "onehot" if _seq_onehot(self.engine, params) else "pallas"
        return eng, self.lane_T or fb_seq.pick_lane_T(obs_flat.shape[0])

    def prepare_streams(self, params: HmmParams, obs_flat: torch.Tensor,
                        lengths: torch.Tensor):
        """The stream's symbol-only prep, cached on the placed tensors (the
        total length is fetched once per placed input).  The engine
        resolves here, once per fit, as on :class:`LocalBackend`: it reads
        the emission structure on the host."""
        self.resolved, lane_T = self._geometry(params, obs_flat)
        length = sum(_host_lengths(lengths))
        return prep_mod.for_seq(params.n_symbols, obs_flat, length, lane_T=lane_T,
                                onehot=self.resolved == "onehot")

    def __call__(self, params: HmmParams, obs_flat: torch.Tensor, lengths: torch.Tensor,
                 prepared=None) -> SuffStats:
        if prepared is None:
            prepared = self.prepare_streams(params, obs_flat, lengths)
        elif self.resolved is None:
            raise RuntimeError("SeqBackend: call prepare_streams before the E-step")
        return fb_seq.seq_stats(params, obs_flat, sum(_host_lengths(lengths)),
                                lane_T=prepared.lane_T, engine=self.resolved,
                                prepared=prepared, one_pass=self.one_pass, t_tile=self.t_tile,
                                fused=self.fuse_fb)


class Seq2DBackend:
    """Batch-of-sequences E-step: each row (one FASTA record, as
    ``pipeline.train_file(backend="seq2d")`` lays them out) is ONE whole
    sequence, and the statistics are the exact per-record counts, summed.

    One device (dp = sp = 1; a ``mesh`` raises, ROADMAP A9).  A group whose
    rows fit ``SMALL_RECORD_ROWS_MAX`` runs the rows-chunked route: the
    chunked kernels with one whole record per lane (exact), on the engine
    ``resolve_fb_engine`` picks.  Longer rows run ``fb_seq.seq_stats`` one
    after another, summed in row order from zero counts (the JAX package
    sums them in a ``lax.scan``).  ``None`` knobs mean the legacy defaults,
    as on :class:`SeqBackend`; ``one_pass`` reaches the long rows only (the
    rows-chunked route is one pass already)."""

    def __init__(self, mesh=None, block_size: Optional[int] = None,
                 pad_value: int = chunking.PAD_SYMBOL, engine: str = "auto",
                 lane_T: Optional[int] = None, t_tile: Optional[int] = None,
                 one_pass: Optional[bool] = None):
        if mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
        _check_seq_engine(engine)
        self.block_size = fb_sharded.DEFAULT_BLOCK if block_size is None else int(block_size)
        self.pad_value = pad_value
        self.engine = engine
        self.lane_T = lane_T
        self.t_tile = fb_chunked.DEFAULT_T_TILE if t_tile is None else int(t_tile)
        self.one_pass = bool(one_pass)

    def prepare(self, chunked):
        """Pad each group's columns to a block multiple (one device: no row
        padding).  A Bucketed input keeps its groups."""
        pad = lambda c, l: fb_sharded.pad_batch2d(c, l, 1, 1, self.block_size, self.pad_value)
        if isinstance(chunked, chunking.Bucketed):
            groups = [pad(c, l) for c, l in zip(chunked.chunks, chunked.lengths)]
            return chunking.Bucketed(chunks=tuple(c for c, _ in groups),
                                     lengths=tuple(l for _, l in groups), total=chunked.total)
        obs, lengths = pad(chunked.chunks, chunked.lengths)
        if obs is chunked.chunks:
            return chunked
        return chunking.Chunked(chunks=obs, lengths=lengths, total=chunked.total)

    def place(self, chunked, device) -> tuple:
        """(tuple of [N_g, T_g] uint8, tuple of [N_g] int32) on ``device``,
        one tensor per group."""
        if isinstance(chunked, chunking.Bucketed):
            groups = zip(chunked.chunks, chunked.lengths)
        else:
            groups = [(chunked.chunks, chunked.lengths)]
        placed = [(chunking.upload(c, device),
                   torch.from_numpy(np.asarray(l, np.int32)).to(device)) for c, l in groups]
        return tuple(c for c, _ in placed), tuple(l for _, l in placed)

    def _group_prep(self, params: HmmParams, rows: torch.Tensor, lens: torch.Tensor):
        """(route, engine, prep) of one placed group: the rows-chunked route
        with one PreparedChunked, or the long rows with one PreparedSeq per
        row (cached on the placed group)."""
        if rows.dim() != 2:
            raise ValueError("Seq2DBackend expects placed [N, T] groups; run prepare() + "
                             "place() first")
        S, T = params.n_symbols, int(rows.shape[1])
        _check_seq_shard(T, "Seq2DBackend", rows.device)
        if T <= SMALL_RECORD_ROWS_MAX:
            eng = resolve_fb_engine(self.engine, params, "rescaled")
            if eng == "xla":
                return "rows", eng, None
            prep = prep_mod.cached_build(
                "chunked-seq2d", (rows, lens), (S, self.t_tile, eng),
                lambda: prepare_chunked(S, rows, lens, t_tile=self.t_tile,
                                        onehot=eng == "onehot"))
            return "rows", eng, prep
        _use_fused_seq(self.engine, params)
        eng = "onehot" if _seq_onehot(self.engine, params) else "pallas"
        lane_T = self.lane_T or fb_seq.pick_lane_T(T)
        host_lens = _host_lengths(lens)
        preps = prep_mod.cached_build(
            "seq2d-rows", (rows, lens), (S, lane_T, eng),
            lambda: [prepare_seq(S, rows[r], host_lens[r], lane_T=lane_T,
                                 onehot=eng == "onehot") for r in range(rows.shape[0])])
        return "seq", eng, (preps, host_lens)

    def prepare_streams(self, params: HmmParams, chunks: tuple, lengths: tuple) -> list:
        """Every group's route and prep, built once per fit."""
        return [self._group_prep(params, c, l) for c, l in zip(chunks, lengths)]

    def __call__(self, params: HmmParams, chunks: tuple, lengths: tuple,
                 prepared=None) -> SuffStats:
        if not isinstance(chunks, tuple):
            raise ValueError("Seq2DBackend expects the placed groups of place(); run "
                             "prepare() + place() first")
        if prepared is None:
            prepared = self.prepare_streams(params, chunks, lengths)
        total = None
        for (route, eng, prep), rows, lens in zip(prepared, chunks, lengths):
            if route == "rows" and eng == "xla":
                st = forward_backward.batch_stats(params, rows, lens, mode="rescaled")
            elif route == "rows":
                st = fb_chunked.batch_stats(params, rows, lens, prepared=prep, engine=eng)
            else:
                preps, host_lens = prep
                st = SuffStats.zeros(params.n_states, params.n_symbols, device=rows.device)
                for r, (p_r, n_r) in enumerate(zip(preps, host_lens)):
                    st = st + fb_seq.seq_stats(params, rows[r], n_r, lane_T=p_r.lane_T,
                                               engine=eng, prepared=p_r,
                                               one_pass=self.one_pass, t_tile=self.t_tile)
            total = st if total is None else total + st
        return total


def get_backend(name: str = "local", *, mode: str = "rescaled", engine: str = "auto",
                mesh=None):
    """Backend factory — the runtime flag: ``local``, ``seq`` or ``seq2d``
    on one device; ``spmd`` and a ``mesh`` raise (ROADMAP A9)."""
    if name == "local":
        if mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
        return LocalBackend(mode=mode, engine=engine)
    if name == "spmd":
        raise NotImplementedError(_MULTI_DEVICE)
    if name in ("seq", "seq2d"):
        # The whole-sequence backends have fixed rescaled numerics.
        if mode != "rescaled":
            raise ValueError(f"backend {name!r} implements rescaled numerics only")
        if name == "seq":
            return SeqBackend(mesh=mesh, engine=engine)
        return Seq2DBackend(mesh=mesh, engine=engine)
    raise ValueError(
        f"unknown backend {name!r} (expected 'local', 'spmd', 'seq', or 'seq2d')"
    )
