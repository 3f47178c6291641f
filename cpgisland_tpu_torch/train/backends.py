"""E-step execution backends behind the reference's mapper/reducer contract.

Counterpart of ``cpgisland_tpu/train/backends.py``, on the reduced
(one-hot) and dense ("pallas") kernel engines and the generic "xla"
engines (``ops.forward_backward`` for chunks: any model, both numerics;
the lane path of ``parallel.fb_sharded`` for whole sequences), which the
backends take wherever the JAX router does.  The reference
trains by one MR job per EM iteration: mappers run forward-backward over
65,536-symbol chunks and emit expected counts, the reduce sums them
(CpGIslandFinder.java:200-201).  :class:`LocalBackend` keeps that framing:
the chunk batch is one tensor on the card, every chunk one lane of the
E-step kernels, and the reduce a sum over lanes.  The whole-sequence
backends drop the chunk-independence approximation:
:class:`SeqBackend` trains on the whole input as ONE sequence and
:class:`Seq2DBackend` on every FASTA record as its own whole sequence
(``ops.fb_seq.seq_stats`` or the lane path: exact boundary messages
between lanes and shards).
:class:`FamilyEStep` and :func:`fit_family` train M reduced members of one
alphabet in lockstep through the stacked kernels.

Every backend has ``prepare(chunked)`` (the input layout, on the host),
``place`` (one upload per fit), ``prepare_streams`` (the symbol-only prep,
once per fit) and ``__call__(params, chunks, lengths, prepared=)`` (one
E-step).  :class:`SpmdBackend` splits the chunk batch over a mesh's data
axis; ``SeqBackend`` and ``Seq2DBackend`` split whole sequences over a
mesh (``parallel.mesh``: one process drives every entry, and the
statistics are summed on the first one).
"""

from __future__ import annotations

import dataclasses
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
from cpgisland_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, auto_mesh2d, check_mesh, make_mesh
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


def _reject_bucketed(backend, chunked) -> None:
    if isinstance(chunked, chunking.Bucketed):
        raise ValueError(f"{type(backend).__name__} does not support Bucketed input "
                         "(Seq2DBackend does)")


class SpmdBackend:
    """Chunk-sharded E-step over a mesh's data axis: the chunk batch [N, T]
    splits into one contiguous block of rows per mesh entry (``prepare``
    pads N to a multiple of the axis with zero-length chunks, which add
    exactly-zero statistics), every entry runs :class:`LocalBackend`'s
    E-step on its block on its device, and the statistics are summed on
    the mesh's first device in mesh order — the single-controller form of
    the JAX package's ``shard_map`` + ``psum`` (the reduce that replaces
    Hadoop's shuffle).  The model is copied to each entry's device, the
    reference's distributed cache.  ``mesh``: a 1-D port mesh (default:
    ``make_mesh`` on the fit's device, every local card for "cuda")."""

    def __init__(self, mesh=None, mode: str = "rescaled", axis: str = "data",
                 engine: str = "auto", fuse_fb: Optional[bool] = None):
        self.mesh = check_mesh(mesh)
        self.mode = mode
        self.axis = axis
        self.engine = engine
        self.local = LocalBackend(mode=mode, engine=engine, fuse_fb=fuse_fb)

    def bind(self, device) -> None:
        """Build the default mesh on the fit's device (a given mesh stays)."""
        if self.mesh is None:
            self.mesh = make_mesh(axis=self.axis, device=device)

    @property
    def home(self):
        return None if self.mesh is None else self.mesh.first

    def _mesh(self) -> Mesh:
        if self.mesh is None:
            raise ValueError("SpmdBackend: no mesh; pass mesh= or call bind(device) first")
        return self.mesh

    def prepare(self, chunked: chunking.Chunked) -> chunking.Chunked:
        _reject_bucketed(self, chunked)
        return chunking.pad_to_multiple(chunked, self._mesh().size)

    def place(self, chunked: chunking.Chunked, device=None) -> tuple:
        """One block of rows per mesh entry, uploaded once to its device:
        (tuple of [N / D, T] uint8, tuple of [N / D] int32)."""
        devs = self._mesh().device_list
        n = chunked.num_chunks
        if n % len(devs):
            raise ValueError(f"chunk count {n} not divisible by mesh axis '{self.axis}' size "
                             f"{len(devs)}; call prepare() first")
        R = n // len(devs)
        chunks = tuple(chunking.upload(np.ascontiguousarray(chunked.chunks[i * R:(i + 1) * R]), d)
                       for i, d in enumerate(devs))
        lengths = tuple(chunking.upload(np.ascontiguousarray(chunked.lengths[i * R:(i + 1) * R]),
                                        d) for i, d in enumerate(devs))
        return chunks, lengths

    def prepare_streams(self, params: HmmParams, chunks: tuple, lengths: tuple) -> list:
        """Every block's symbol-only prep on its device, built once per
        placed input (ONE cache entry for the whole mesh; None per block
        for the generic engine).  The engine resolves here, once per fit,
        as on :class:`LocalBackend`."""
        self.local.resolved = resolve_fb_engine(self.engine, params, self.mode)
        eng = self.local.resolved
        if eng == "xla":
            return [None] * len(chunks)  # the generic engine reads the chunks as they are
        return prep_mod.cached_build(
            "chunked-spmd", tuple(chunks) + tuple(lengths),
            (params.n_symbols, fb_chunked.DEFAULT_T_TILE, eng),
            lambda: [prepare_chunked(params.n_symbols, c, l, t_tile=fb_chunked.DEFAULT_T_TILE,
                                     onehot=eng == "onehot") for c, l in zip(chunks, lengths)])

    def __call__(self, params: HmmParams, chunks: tuple, lengths: tuple,
                 prepared=None) -> SuffStats:
        if not isinstance(chunks, tuple):
            raise ValueError("SpmdBackend expects the placed blocks of place(); run prepare() + "
                             "place() first")
        if prepared is None:
            prepared = self.prepare_streams(params, chunks, lengths)
        ps = fb_sharded.shard_params(params, chunks)
        return fb_sharded.sum_stats([self.local(p, c, l, prepared=prepared[i])
                                     for i, (p, c, l) in enumerate(zip(ps, chunks, lengths))])


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
    """Refuse a whole-sequence shard longer than its card's budget with
    advice, before any allocation fails (``device``: the shard's own)."""
    budget = seq_shard_budget(device)
    if budget is not None and shard_len > budget:
        alt = ("a bigger seq axis in the group meshes" if what == "Seq2DBackend"
               else "a bigger mesh, or per-record rows with backend='seq2d'")
        raise ValueError(
            f"{what}: a whole-sequence shard of {shard_len} symbols exceeds the "
            f"~{budget >> 20} Mi single-card whole-sequence E-step budget (measured "
            f"footprint ~{SEQ_BYTES_PER_SYMBOL} B/symbol against "
            f"~{(budget * SEQ_BYTES_PER_SYMBOL) >> 30} GiB usable device memory) — shard "
            f"time over more devices ({alt}), or use the chunked 'local' / 'spmd' "
            "backend (the reference's own framing)"
        )


def _use_fused_seq(engine: str, params: HmmParams) -> bool:
    """Route a whole-sequence E-step to the kernels (True) or to the
    generic lane path (``parallel.fb_sharded``, False).  "xla" takes the
    lane path, as does "auto" for a model outside both kernel domains; an
    explicit "pallas" / "onehot" is validated against the model.  The JAX
    package also sends "auto" to its lane path under a 1 Mi shard and off
    the TPU (the TPU's 128-lane padding); here "auto" keeps the kernels at
    every size."""
    if engine == "xla":
        return False
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
    return fb_pallas.supports(params) or _seq_onehot(engine, params)


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


def _seq_engine(engine: str, params: HmmParams) -> str:
    """The resolved whole-sequence engine: "onehot", "pallas" or "xla"
    (the lane path)."""
    if not _use_fused_seq(engine, params):
        return "xla"
    return "onehot" if _seq_onehot(engine, params) else "pallas"


def _host_lengths(lengths: torch.Tensor) -> list:
    """The placed lengths on the host, fetched once per placed tensor."""
    return prep_mod.cached_build("seq-lengths", (lengths,), (),
                                 lambda: [int(x) for x in lengths.cpu().reshape(-1)])


def _shard_preps(kind: str, params: HmmParams, shards, lengths, lane_T: int, onehot: bool):
    """(per-shard preps, entry symbols) of one sequence split over a mesh's
    shards, built once per placed input (ONE cache entry for all shards)."""
    def build():
        ents = fb_sharded.entry_symbols(shards, lengths, params.n_symbols, 0)
        return (fb_seq.prepare_shards(params, shards, lengths, lane_T=lane_T, onehot=onehot,
                                      entry_syms=ents), ents)

    return prep_mod.cached_build(kind, tuple(shards),
                                 (params.n_symbols, tuple(int(n) for n in lengths), lane_T,
                                  onehot), build)


@dataclasses.dataclass(frozen=True)
class LanePrep:
    """The lane path's "prep": the real-symbol counts of the placed shards,
    read on the host once per fit (the lane path lays its shards out each
    call)."""

    lengths: list


class SeqBackend:
    """Exact whole-sequence E-step: the ENTIRE training input is ONE
    sequence (n_seqs 1) — no 65,536-symbol independence approximation and
    no dropped boundary transition pairs, unlike the reference's chunked
    mapper contract (CpGIslandFinder.java:130-141) — split along time over
    a mesh's ``seq`` axis with the boundary-message exchange between the
    shards (``parallel.fb_sharded``).  Rescaled probability numerics;
    ``engine`` picks the lowering: the kernels (auto / pallas / onehot)
    or the generic lane path ("xla", and "auto" for a model outside both
    kernel domains).

    ``mesh``: a 1-D port mesh (default: ``make_mesh`` on the fit's device,
    every local card for "cuda"; one entry on the CPU).  A one-entry mesh
    runs the one-device E-step (``fb_seq.seq_stats``, no exchange).
    ``lane_T``: steps per kernel lane (None: ``fb_seq.pick_lane_T`` of the
    shard).  The JAX package's ``None`` defaults read its tuner table,
    which the port does not have (ROADMAP A14): here ``t_tile=None`` means
    ``fb_chunked.DEFAULT_T_TILE``, ``fuse_fb=None`` True and
    ``one_pass=None`` False — its shipped legacy defaults.
    ``fuse_fb=False`` runs the reduced engine's split chains (B9, B10 in
    place of B4; B5 stays, exact over their cs-scaled betas).
    ``one_pass=True`` runs B8 in place of B7 and B4 on the reduced engine's
    kernel-stats route (power-of-two alphabets), whatever ``fuse_fb`` says;
    elsewhere it is ignored, bit for bit."""

    def __init__(self, mesh=None, block_size: Optional[int] = None, axis: str = SEQ_AXIS,
                 pad_value: int = chunking.PAD_SYMBOL, engine: str = "auto",
                 lane_T: Optional[int] = None, t_tile: Optional[int] = None,
                 fuse_fb: Optional[bool] = None, one_pass: Optional[bool] = None):
        _check_seq_engine(engine)
        self.mesh = check_mesh(mesh)
        self.axis = axis
        self.block_size = fb_sharded.DEFAULT_BLOCK if block_size is None else int(block_size)
        self.pad_value = pad_value
        self.engine = engine
        self.lane_T = lane_T
        self.t_tile = fb_chunked.DEFAULT_T_TILE if t_tile is None else int(t_tile)
        self.fuse_fb = True if fuse_fb is None else bool(fuse_fb)
        self.one_pass = bool(one_pass)
        self.resolved: Optional[str] = None

    def bind(self, device) -> None:
        """Build the default mesh on the fit's device (a given mesh stays)."""
        if self.mesh is None:
            self.mesh = make_mesh(axis=self.axis, device=device)

    @property
    def home(self):
        return None if self.mesh is None else self.mesh.first

    @property
    def n_dev(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def prepare(self, chunked: chunking.Chunked) -> chunking.Chunked:
        """Re-frame any chunk batch as one stream split over the mesh, each
        shard padded to a block multiple: chunks [D, L]."""
        _reject_bucketed(self, chunked)
        stream = (np.concatenate([np.asarray(c[:l]) for c, l in
                                  zip(chunked.chunks, chunked.lengths)])
                  if chunked.num_chunks else np.zeros(0, np.uint8))
        obs_p, lengths = fb_sharded.shard_sequence(stream, self.n_dev, self.block_size,
                                                   pad_value=self.pad_value)
        return chunking.Chunked(chunks=obs_p.reshape(self.n_dev, -1), lengths=lengths,
                                total=int(stream.shape[0]))

    def place(self, chunked: chunking.Chunked, device=None) -> tuple:
        """Uploaded once: on a one-entry mesh the flat stream [L] and its
        length [1] on the entry's device (``device`` without a mesh); on a
        larger mesh one shard [L] per entry on its device and the host
        lengths."""
        if self.n_dev == 1:
            dev = device if self.mesh is None else self.mesh.first
            return (torch.from_numpy(np.ascontiguousarray(chunked.chunks).reshape(-1)).to(dev),
                    torch.from_numpy(np.asarray(chunked.lengths)).to(dev))
        if chunked.chunks.shape[0] != self.n_dev:
            raise ValueError(f"prepared {chunked.chunks.shape[0]} shards for a mesh of "
                             f"{self.n_dev}; run this backend's prepare() first")
        return (fb_sharded.place_shards(self.mesh, chunked.chunks.reshape(-1)),
                tuple(int(n) for n in chunked.lengths))

    def _geometry(self, params: HmmParams, obs_flat):
        """(engine, lane_T) of a placed input: the one routing point."""
        shards = obs_flat if isinstance(obs_flat, tuple) else (obs_flat,)
        for o in shards:
            if o.dim() != 1:
                raise ValueError(f"SeqBackend expects flat placed [L] shards, got shape "
                                 f"{tuple(o.shape)}; run prepare() + place() first")
            if o.shape[0] % self.block_size:
                raise ValueError(f"shard length {o.shape[0]} not a multiple of "
                                 f"block_size = {self.block_size}; run prepare() first")
            _check_seq_shard(o.shape[0], "SeqBackend", o.device)
        eng = _seq_engine(self.engine, params)
        return eng, self.lane_T or fb_seq.pick_lane_T(shards[0].shape[0])

    def prepare_streams(self, params: HmmParams, obs_flat, lengths):
        """The symbol-only prep of the placed input, cached on the placed
        tensors (the total length is fetched once per placed input; a
        :class:`LanePrep` on the lane path, which lays its shards out each
        call).  The
        engine resolves here, once per fit: it reads the emission
        structure on the host."""
        self.resolved, lane_T = self._geometry(params, obs_flat)
        if self.resolved == "xla":
            lens = list(lengths) if isinstance(obs_flat, tuple) else _host_lengths(lengths)
            return LanePrep(lengths=lens)
        if isinstance(obs_flat, tuple):
            return _shard_preps("seq-mesh", params, obs_flat, lengths, lane_T,
                                self.resolved == "onehot")
        length = sum(_host_lengths(lengths))
        return prep_mod.for_seq(params.n_symbols, obs_flat, length, lane_T=lane_T,
                                onehot=self.resolved == "onehot")

    def __call__(self, params: HmmParams, obs_flat, lengths, prepared=None) -> SuffStats:
        if prepared is None:
            prepared = self.prepare_streams(params, obs_flat, lengths)
        elif self.resolved is None:
            raise RuntimeError("SeqBackend: call prepare_streams before the E-step")
        if isinstance(prepared, LanePrep):
            shards = obs_flat if isinstance(obs_flat, tuple) else [obs_flat]
            lens = prepared.lengths if isinstance(obs_flat, tuple) else [sum(prepared.lengths)]
            return fb_sharded.lane_stats(params, shards, lens, block_size=self.block_size)
        if isinstance(obs_flat, tuple):
            mesh = self.mesh
            preps, ents = prepared
            fn = fb_sharded.sharded_stats_pallas_fn(
                mesh, preps[0].lane_T, self.resolved == "onehot", self.fuse_fb, self.one_pass)
            return fn(params, obs_flat, list(lengths), prepared=preps, entry_syms=ents)
        return fb_seq.seq_stats(params, obs_flat, sum(_host_lengths(lengths)),
                                lane_T=prepared.lane_T, engine=self.resolved,
                                prepared=prepared, one_pass=self.one_pass, t_tile=self.t_tile,
                                fused=self.fuse_fb)


class MeshGroup:
    """One bucket group of :class:`Seq2DBackend` placed on a 2-D mesh of
    more than one entry: ``tiles[i][j]`` [N / dp, T / sp] on device (i, j)
    (``fb_sharded.place_batch2d``); the lengths travel beside it as the
    host [N, sp] array."""

    def __init__(self, mesh: Mesh, tiles: tuple, T: int):
        self.mesh, self.tiles, self.T = mesh, tiles, T


class Seq2DBackend:
    """Batch-of-sequences E-step: each row (one FASTA record, as
    ``pipeline.train_file(backend="seq2d")`` lays them out) is ONE whole
    sequence, and the statistics are the exact per-record counts, summed.

    On a 2-D (data x seq) mesh: rows over the data axis, each row's time
    over the seq axis.  ``mesh=None`` gives every bucket group its own
    split of the fit's devices (``auto_mesh2d`` of its row count; on the
    CPU and on one card 1 x 1).  A 1 x 1 group runs on its device: rows
    that fit ``SMALL_RECORD_ROWS_MAX`` take the rows-chunked route (the
    chunked E-step with one whole record per lane — exact —, on the engine
    ``resolve_fb_engine`` picks), longer rows ``fb_seq.seq_stats`` or the
    lane path one after another, summed in row order from zero counts (the
    JAX package sums them in a ``lax.scan``).  A larger group splits its
    rows over dp (``fb_sharded.sharded_stats2d_rows_fn``, when sp = 1 and
    the rows fit a lane) or runs every row over its data row's seq shards
    with the exchange (``sharded_stats2d_fn``).  ``None`` knobs mean the
    legacy defaults, as on :class:`SeqBackend`; ``one_pass`` reaches the
    long rows only (the rows-chunked route is one pass already)."""

    def __init__(self, mesh=None, block_size: Optional[int] = None,
                 pad_value: int = chunking.PAD_SYMBOL, engine: str = "auto",
                 lane_T: Optional[int] = None, t_tile: Optional[int] = None,
                 one_pass: Optional[bool] = None):
        mesh = check_mesh(mesh)
        if mesh is not None and len(mesh.axis_names) != 2:
            raise ValueError(f"Seq2DBackend needs a 2-D mesh, got axes {mesh.axis_names}")
        _check_seq_engine(engine)
        self.mesh = mesh
        self.block_size = fb_sharded.DEFAULT_BLOCK if block_size is None else int(block_size)
        self.pad_value = pad_value
        self.engine = engine
        self.lane_T = lane_T
        self.t_tile = fb_chunked.DEFAULT_T_TILE if t_tile is None else int(t_tile)
        self.one_pass = bool(one_pass)
        self._device = None
        self._group_meshes: Optional[list] = None

    def bind(self, device) -> None:
        """The device the default per-group meshes are built on (the first
        one bound stays)."""
        if self._device is None:
            self._device = device

    @property
    def home(self):
        return None if self.mesh is None else self.mesh.first

    def _mesh_for(self, n_rows: int) -> Optional[Mesh]:
        if self.mesh is not None:
            return self.mesh
        if self._device is None:
            return None
        return auto_mesh2d(n_rows, device=self._device)

    def prepare(self, chunked):
        """Pad each group's rows to a multiple of its mesh's dp (zero-length
        rows) and its columns to a multiple of sp * block_size.  A Bucketed
        input keeps its groups."""
        groups = (list(zip(chunked.chunks, chunked.lengths))
                  if isinstance(chunked, chunking.Bucketed)
                  else [(chunked.chunks, chunked.lengths)])
        self._group_meshes = [self._mesh_for(np.asarray(c).shape[0]) for c, _ in groups]
        padded = []
        for (c, l), m in zip(groups, self._group_meshes):
            dp, sp = (1, 1) if m is None else m.devices.shape
            padded.append(fb_sharded.pad_batch2d(c, l, dp, sp, self.block_size, self.pad_value))
        if isinstance(chunked, chunking.Bucketed):
            return chunking.Bucketed(chunks=tuple(c for c, _ in padded),
                                     lengths=tuple(l for _, l in padded), total=chunked.total)
        obs, lengths = padded[0]
        if obs is chunked.chunks:
            return chunked
        return chunking.Chunked(chunks=obs, lengths=lengths, total=chunked.total)

    def place(self, chunked, device=None) -> tuple:
        """(tuple per group, tuple per group), uploaded once: a 1 x 1 group
        as its [N_g, T_g] uint8 tensor and [N_g] int32 lengths on its
        device; a larger group as a :class:`MeshGroup` and its host [N_g,
        sp] lengths."""
        if isinstance(chunked, chunking.Bucketed):
            groups = list(zip(chunked.chunks, chunked.lengths))
        else:
            groups = [(chunked.chunks, chunked.lengths)]
        meshes = self._group_meshes
        if meshes is None or len(meshes) != len(groups):
            meshes = [self._mesh_for(np.asarray(c).shape[0]) for c, _ in groups]
        out_c, out_l = [], []
        for (c, l), m in zip(groups, meshes):
            if m is None or m.size == 1:
                dev = device if m is None else m.first
                out_c.append(chunking.upload(c, dev))
                out_l.append(torch.from_numpy(np.asarray(l, np.int32)).to(dev))
                continue
            tiles, lens2d = fb_sharded.place_batch2d(m, c, l)
            out_c.append(MeshGroup(m, tiles, int(np.asarray(c).shape[1])))
            out_l.append(lens2d)
        return tuple(out_c), tuple(out_l)

    def _group_prep(self, params: HmmParams, rows, lens):
        """(route, engine, prep) of one placed group: "rows" (the chunked
        E-step, one record per lane), "seq" (whole sequences through the
        kernels) or "lane" (the lane path), cached on the placed group."""
        S = params.n_symbols
        if isinstance(rows, MeshGroup):
            return self._mesh_group_prep(params, rows, lens)
        if rows.dim() != 2:
            raise ValueError("Seq2DBackend expects placed [N, T] groups; run prepare() + "
                             "place() first")
        T = int(rows.shape[1])
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
        eng = _seq_engine(self.engine, params)
        host_lens = _host_lengths(lens)
        if eng == "xla":
            return "lane", eng, host_lens
        lane_T = self.lane_T or fb_seq.pick_lane_T(T)
        preps = prep_mod.cached_build(
            "seq2d-rows", (rows, lens), (S, lane_T, eng),
            lambda: [prepare_seq(S, rows[r], host_lens[r], lane_T=lane_T,
                                 onehot=eng == "onehot") for r in range(rows.shape[0])])
        return "seq", eng, (preps, host_lens)

    def _mesh_group_prep(self, params: HmmParams, group: MeshGroup, lens2d):
        S = params.n_symbols
        mesh, tiles = group.mesh, group.tiles
        dp, sp = mesh.devices.shape
        for row in tiles:
            for t in row:
                _check_seq_shard(int(t.shape[1]), "Seq2DBackend", t.device)
        R = int(tiles[0][0].shape[0])
        flat = tuple(t for row in tiles for t in row)
        if sp == 1 and group.T <= SMALL_RECORD_ROWS_MAX:
            eng = resolve_fb_engine(self.engine, params, "rescaled")
            if eng == "xla":
                return "mesh-rows", eng, None

            def build():
                return [prepare_chunked(S, row[0], torch.from_numpy(np.ascontiguousarray(
                    lens2d[i * R:(i + 1) * R, 0])).to(row[0].device), t_tile=self.t_tile,
                    onehot=eng == "onehot") for i, row in enumerate(tiles)]

            return "mesh-rows", eng, prep_mod.cached_build(
                "chunked-seq2d-mesh", flat, (S, self.t_tile, eng), build)
        eng = _seq_engine(self.engine, params)
        if eng == "xla":
            return "mesh-seq", eng, None
        lane_T = self.lane_T or fb_seq.pick_lane_T(int(tiles[0][0].shape[1]))

        def build_rows():
            out = []
            for i, row in enumerate(tiles):
                for r in range(R):
                    shards = [t[r] for t in row]
                    lens = [int(x) for x in lens2d[i * R + r]]
                    ents = fb_sharded.entry_symbols(shards, lens, S, 0)
                    out.append((fb_seq.prepare_shards(params, shards, lens, lane_T=lane_T,
                                                      onehot=eng == "onehot",
                                                      entry_syms=ents), ents))
            return out

        return "mesh-seq", eng, (lane_T, prep_mod.cached_build(
            "seq2d-mesh", flat, (S, lane_T, eng), build_rows))

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
            if route == "mesh-rows":
                st = fb_sharded.sharded_stats2d_rows_fn(rows.mesh, eng, self.t_tile)(
                    params, rows.tiles, lens, prepared=prep)
            elif route == "mesh-seq":
                lane_T, row_preps = (None, None) if prep is None else prep
                st = fb_sharded.sharded_stats2d_fn(
                    rows.mesh, self.block_size, eng, lane_T, self.one_pass)(
                    params, rows.tiles, lens, prepared=row_preps)
            elif route == "rows" and eng == "xla":
                st = forward_backward.batch_stats(params, rows, lens, mode="rescaled")
            elif route == "rows":
                st = fb_chunked.batch_stats(params, rows, lens, prepared=prep, engine=eng)
            elif route == "lane":
                st = SuffStats.zeros(params.n_states, params.n_symbols, device=rows.device)
                for r, n_r in enumerate(prep):
                    st = st + fb_sharded.lane_stats(params, [rows[r]], [n_r],
                                                    block_size=self.block_size)
            else:
                preps, host_lens = prep
                st = SuffStats.zeros(params.n_states, params.n_symbols, device=rows.device)
                for r, (p_r, n_r) in enumerate(zip(preps, host_lens)):
                    st = st + fb_seq.seq_stats(params, rows[r], n_r, lane_T=p_r.lane_T,
                                               engine=eng, prepared=p_r,
                                               one_pass=self.one_pass, t_tile=self.t_tile)
            total = st if total is None else fb_sharded.sum_stats([total, st])
        return total


def get_backend(name: str = "local", *, mode: str = "rescaled", engine: str = "auto",
                mesh=None):
    """Backend factory — the runtime flag: ``local`` (one device),
    ``spmd`` (chunks over a mesh's data axis), ``seq`` and ``seq2d``
    (whole sequences over a mesh)."""
    mesh = check_mesh(mesh)
    if name == "local":
        return LocalBackend(mode=mode, engine=engine)
    if name == "spmd":
        return SpmdBackend(mesh=mesh, mode=mode, engine=engine)
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
