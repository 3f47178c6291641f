#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each one against its plain PyTorch version
on the card, drives the decode, training and posterior main paths end to
end (a seeded chromosome-sized FASTA) and checks the results.  Phases, one
JSON line each:

1. card: name and power limit, kernel build time, and (its own line) the
   ptxas registers and spills of the kernels redesigned (B4, B24, B17, B7
   / B21, B18 and B16 with their sub-lane and state-split kernels, B5's
   part kernel, the scoring kernels, B9 / B22 and B10 / B23, one chain
   and in sub-lanes, with B11 beside them, the Viterbi backpointer
   chains B2 / B6 / B27 and B14 with their streams read ahead, B1 / B26
   and B13 one row of the product a thread, B3 / B28 in segments joined
   by exact bits and B15 in segments joined by exact K-state maps, B19 in
   B18's sub-lanes and state split, and B12 in B5's part kernel);
2. kernels: B1-B3 at full size (bk=4096, nb=16384: 64 Mi steps, PAD runs
   and record resets in the pair stream), B4-B5 at NL=1024 lanes x
   Tp=65,536 steps (ragged lengths, a short last lane, PAD tails), and B7
   at the posterior's geometry, NL=8192 lanes x lane_T=8192 steps (64 Mi
   steps, a short last lane with a PAD tail), where B4 is timed again —
   B1-B4 and B7 bit-equal to their plain versions, B5 within rtol 1e-5 /
   atol 1e-3 — with median time, bound and plain-version time; B4 at both
   geometries at its default sub-lanes (``fb_onehot.sublanes``) and in one
   sub-lane (G = 1), each bit-equal to its plain version, and timed at
   2, 4 and 8 Ki sub-lanes (the sweep, with each one's largest relative
   difference from G = 1); B7 likewise at its default sub-lanes
   (``fb_onehot.prod_sublanes``) and in one sub-lane, each bit-equal to
   its plain version, and timed at 2 Ki, 1 Ki, 512 and 256-step
   sub-lanes; B5 also at the seq geometry (the posterior lanes' B4
   streams, random entering messages, every lane's t == 0 pair but lane
   0's) and at the genome's own shapes (1,390 training chunks, 11,121 seq
   lanes), at each of the four at its segment rule
   (``fb_onehot.stats_segment_t``), two launches bit-equal, and in
   segments of 128 to 4 Ki steps and the layout's old t-tile (the sweep:
   the part and the reduce kernel timed apart by torch.profiler, the
   whole call by CUDA events, blocks, blocks an SM and waves, agreement
   with the plain version);
3. main path, decode: ``pipeline.decode_file`` on a 64 Mi-base record plus
   256 scaffolds, clean then compat, with per-phase wall seconds and the
   launch counts of that run (B1-B3 each > 0);
4. main path, train: ``pipeline.train_file`` on the same FASTA, compat then
   clean, 5 EM iterations each (convergence 0: fixed work), with per-phase
   seconds, EM Msym/s, the logliks (non-decreasing within f32 noise) and the
   launch counts (B4 and B5 exactly 5 per mode);
5. parity: the first 4 Mi symbols of the big record decoded through the
   plain versions on the card must give the kernels' path (or, under the
   tie contract, the same f64 path score); a small FASTA must give
   byte-identical island files on the CPU and on the card; a 3-iteration
   fit on 4 Mi symbols through the plain versions must match the kernels'
   (logliks rtol 1e-5, probabilities atol 1e-5); and ``pipeline.run`` of a
   small FASTA on the CPU and on the card must give model dumps within
   atol 1e-5 with the same structural zeros and identical island files;
6. run: ``pipeline.run`` in compat mode at the reference defaults
   (convergence 0.005, 10 iterations) on the FASTA, with the launch counts
   of that run (all five decode and training kernels > 0);
7. posterior: ``pipeline.posterior_file`` on the same FASTA (islands and
   confidence) at the default span (the big record in one pass, the
   scaffolds batched: B7 launches exactly once) and at a 16 Mi span (the
   big record in 4 spans: B7 exactly 8 times, 4 transfer totals and 4
   posterior sweeps), B4 > 0 in both; the two runs must give identical
   island files, mean confidence within 1e-6 and confidence within atol
   1e-4.  Then parity: the posterior of the first 4 Mi symbols through the
   plain versions on the card must equal the kernels' bit for bit (the
   same MPM path), and a small FASTA with records longer than a 32 Ki span
   must give identical island files and confidence within atol 1e-5 on
   the CPU and on the card;
8. profile: device time by kernel over one decode of the big record, the
   device island engine on its path, one EM iteration and one posterior
   of the big record, and the device's idle share of each;
9. dense kernels: B13-B15 at bk=4096, nb=16384 (64 Mi steps with PAD
   runs) for K=8 (the flagship's tables through the dense engine) and K=2
   (the two_state preset), each bit-equal to its plain version, with
   median time, bound and plain-version time;
10. dense main path: ``pipeline.decode_file`` of the same FASTA, whose big
   record opens with a 10,000-N run, clean with ``invalid_symbols="mask"``
   (the big record is demoted to the dense kernels: B13-B15 > 0, the
   scaffolds keep the flat reduced batch: B1-B3 > 0) and clean with the
   two_state preset and ``island_states=(0,)`` (B13-B15 > 0, B1-B3 = 0),
   with wall, per-phase seconds and launch counts; then B13, B14 and B15
   on the operands of the largest two_state scaffold flush, each bit-equal
   to its plain version, timed through its wrapper and its C entry;
11. island engines: the clean decode and both dense decodes again with
   ``island_engine="host"`` — island files identical to the device
   engine's (the default on the card), islands phase seconds both ways;
12. dense parity: the first 4 Mi symbols of the big record (N-led) through
   the plain versions on the card give the kernels' path at K=8 and K=2,
   and a small N-led FASTA gives identical island files on the CPU and on
   the card for both dense decodes; then profiles of one dense decode of
   the big record at K=8 and at K=2;
13. dense FB kernels: B16, B18 and B20 at NL=1024 x Tp=65,536 (ragged, as
   B4/B5) and B17, B16 and B19 at NL=8192 x lane_T=8192 (a 64 Mi span,
   PAD tail), for K=8 (the flagship's tables) and K=2 (two_state), and B16
   and B18 at both geometries for K=5 (a random model) — B16-B19 bit-equal
   to their plain versions, B20 within rtol 1e-5 / atol 1e-3 — with median
   time, bound and plain-version time, B16 / B18 / B19 rows naming their
   CUDA kernel (``cuda_kernel``: at K >= 5 the state-split chains; B19 in
   B18's sub-lanes at K = 2) and their sub-lanes; B18 also on
   the posterior lanes, and at K = 2 at both geometries in one sub-lane
   (bit-equal to its plain version) and in 256-step and 1, 2, 4 and 8 Ki
   sub-lanes (``fb_pallas.BWD_SUBLANE_T``: timed); B16 likewise at K = 2 in
   one sub-lane (bit-equal to its plain version) and in sub-lanes of 256
   to 4 Ki steps (``fb_pallas.FWD_SUBLANE_T``: timed, each one's largest
   relative difference from G = 1), its row carrying ``sublanes``;
14. dense train: ``pipeline.train_file`` with two_state, compat then clean,
   5 iterations each (B16, B18 and B20 exactly 5 per mode, B4 and B5
   never; EM Msym/s, per-phase seconds, logliks non-decreasing), then the
   flagship through ``engine="pallas"``, clean, whose loglik trajectory
   must match phase 4's reduced one within rtol 1e-5;
15. dense posterior: ``pipeline.posterior_file`` with two_state and
   ``island_states=(0,)``, islands and confidence, at the default span
   (B17 exactly once) and a 16 Mi span (exactly 8), B16 and B18 in both,
   identical island files and confidence within atol 1e-4; then a
   confidence-only run (B19 > 0, B18 never, the path run's confidence
   within 1e-6);
16. dense parity: two_state on the first 4 Mi symbols through the dense
   kernels and through their plain versions on the card (posterior with
   and without the path bit for bit; a 3-iteration fit within rtol 1e-5 /
   atol 1e-5), a small FASTA soft-decoded and trained on the CPU and on
   the card (identical island files, confidence and model dumps within
   1e-5), and profiles of one dense EM iteration and one dense posterior
   of the big record;
17-20. the stacked kernels (B21, B24, B25; against their plain versions at
   M = 2, per member against B7 / B4 / B5 at every M; B21 and B24 also in
   one sub-lane per member against B7 / B4 in one sub-lane) and the scoring
   kernels (in sub-lanes and in one, against their plain versions, at the
   genome record's lanes and at compare's shapes; their sub-lane sweep; the
   record in lanes of 512 steps; a stacked group's members against their
   own launches), the compare main path (three casts, stacked against
   sequential, with the score phase of each) and ``fit_family`` against
   solo fits;
21. flat-batch scores: ``viterbi_parallel_batch(engine="onehot")`` over the
   256 scaffolds in one padded batch (B6 exactly once, B2 never); the
   batch again through the plain B1, B6 and B3 on the card gives the same
   paths and scores bit for bit, and B6's inputs and outputs at this shape
   equal its plain version's; each score within 64 f32 ulps of its stream
   magnitude plus 5e-5 of itself of the record's own ``viterbi_parallel``
   score and of a float64 re-score of its path;
22. the genome decoded clean at a 16 Mi span (the big record in 4 spans),
   flagship and two_state: island files identical to phases 3 and 10;
23. the span-wise decode at full size: one record of 2^28 + 2^25 symbols
   with an island planted across the span boundary, decoded at the
   default span (2 spans, device islands) and in one pass: identical
   island files, the boundary island one call, wall per phase and the
   device memory peak;
24. B8 (the one-pass arm's matrix chains) at a ragged geometry (odd lane
   lengths, empty lanes) and at 8192 x 8192 on the genome's 64 Mi record,
   bit-equal to its plain version, timed beside B7 and B4 on those lanes;
25. whole-sequence training: ``train_file`` clean, 5 iterations,
   convergence 0, with backend "seq" (flagship: B7, B4, B5 exactly 5
   each, no B8), ``SeqBackend(one_pass=True)`` (B8 and B5 exactly 5, no
   B7 or B4), "seq" with two_state (B17, B16, B18 exactly 5), "seq2d"
   (the records one by one) and ``SeqBackend(fuse_fb=False)`` (B7, B9,
   B10, B5 exactly 5 each, no B4): EM Msym/s, phases, peak device memory,
   logliks non-decreasing, the one-pass trajectory within the JAX
   one-pass tests' bound of the two-pass one, the split one within rtol
   1e-5 of it;
26. the device EM loop: seq and local runs with ``fuse="on"`` and "off"
   bit-equal, a real convergence threshold stopping both loops at one
   iteration, the host loop's blocking reads counted (0 in the device
   loop), and each loop's idle share and synchronizing CUDA calls over 5
   iterations, seq and local on both arms, fused and split (none in the
   device loop);
27. a small FASTA trained by seq and seq2d on the CPU and on the card:
   dumps compared byte for byte, held within atol 1e-5;
28. ``posterior_sharded(one_pass=True)`` on the 64 Mi record against the
   two-pass arm: confidence within atol 2e-5, MPM positions differing
   counted, both timed (B8 once, no B7 or B4);
29. peak device bytes per symbol of one seq E-step at 16 Mi and 64 Mi
   symbols (two-pass, one-pass, split, dense K = 8) against
   ``SEQ_BYTES_PER_SYMBOL``, with its device ms, and one seq E-step of
   the genome at lane_T 4096, 8192 and 16384;
30. the split arm's kernels: B9, B10 and B12 at NL=1024 x Tp=65,536
   (ragged, as B4 / B5), B22 and B23 there at M = 2 and 5, B9, B10, B11,
   and B22 and B23 at M = 2, at 8192 x 8192 on the genome's 64 Mi record
   — B9-B11 bit-equal to their plain versions, B22 and B23 too at M = 2,
   B9, B10, B11, B22 and B23 so at their default sub-lanes and in one
   sub-lane (B9 and B22 also to B4's and B24's alphas at both, B11 to the
   confidence over B10's betas at both; B10 also in
   256 to 4 Ki-step sub-lanes, ``fb_pallas.BWD_SUBLANE_T``: timed, each
   one's largest relative difference from G = 1), B22 / B23 per member to
   B9 / B10 at every M, B12 within rtol 1e-5 / atol 1e-3 (two launches
   bit-equal), also at the genome's 1,390 training chunks;
31. ``train_file`` with ``LocalBackend(fuse_fb=False)``, compat then
   clean (B9, B10, B12 exactly 5 each per mode, B4 and B5 never), the
   logliks within rtol 1e-5 of phase 4's;
32. the split posterior: ``posterior_sharded(fused=False)`` on the 64 Mi
   record (B7, B9, B11 once; with the path B7, B9, B10), a continuation
   span, and ``batch_posterior`` over 256 short records, each against the
   fused arm (confidence within atol 2e-5, MPM paths equal, exact launch
   counts), the one-span posterior timed both ways;
33. ``fit_family`` with ``FamilyEStep(fuse_fb=False)`` (one B22, one B23
   and 3 B12 an iteration, logliks within rtol 1e-5 of the fused fit, the
   stacked split E-step equal to the sequential one bit for bit) and
   ``posterior_sharded_stacked(fused=False)`` (B21, B22, B23 once each)
   equal to its members' own split posteriors bit for bit, with the path
   and without, and timed on the card beside the stacked fused posterior;
34. the stacked decode's kernels: B26, B27 (path and scores arms) and B28
   at bk=4096, nb=16384 over a chaining stream with PAD runs and resets,
   for (S, M) in (4, 2), (4, 5), (16, 2) — bit-equal to their plain
   versions and per member to B1 / B2 / B6 / B3, timed beside M x the
   single kernel; at S = 16 (288-row tables) B1, B6 and B3 against their
   plain versions; then B26, B27 (both arms) and B28 at M = 2 and 3, B1,
   B2, B6 and B3 at the largest mixed-model flush's geometry (its 8
   scaffolds padded as phase 35 pads them, one flat reset stream, the
   operands its decode hands B26, B27 and B28), each bit-equal to its
   plain version there and timed through its wrapper and its C entry, the
   shape printed;
35. the mixed-model flush unit ``pipeline._decode_small_batch_stacked``
   over the 256 scaffolds in decode_file's flushes of 8, owners
   round-robin over M = 2 and 3 (the flagship plus random partition=2
   members): B26, B27, B28 once a flush and B1-B3 never, every member's
   paths equal to its own ``decode_batch_flat`` of the flush, island calls
   against the per-model sequential flushes (a differing record's paths
   rescored in float64 must tie), wall and device busy time of both, host
   islands for one model, and ``decode_batch_flat_stacked(return_score=
   True)`` over all scaffolds in one batch (paths and scores equal to each
   member's own flat decode);
36. the pair-composition bench's kernels at its geometry (64 Mi symbols
   as 1024 full lanes of 65,536): T2-T4 (``oh_fwd_strm``, ``oh_fwd_comp``,
   ``oh_fwd_compsel``) bit-equal to their plain versions, T2 to B9 in one
   sub-lane and T4 to T3, all four of T1-T4 within the bench's gate (1e-4)
   of the single-step plain reference (the sequential chain), each kernel
   timed beside its bound and
   the whole variant (streams built) beside it; then the bench itself,
   ``tools/bench_compose.main(["--mib", "64"])``: its JSON line, and the
   launch counters moved by exactly the calls it reports.

Phase 2 also holds B6 (the score-threading backpointer kernel) bit for bit
against its plain version on B2's flat stream, with B2's outputs equal to
B6's first three.  Phases 7 and 15 run the posterior's islands on the
device engine (the default on the card) and then once with the host
engine (identical island files) and once island-only (the confidence
summed on the card, its mean within 1e-6 relative).

Then the kernel table as one JSON object and, last, the ok line.  Exits
non-zero on any failure, or when CUDA is not available.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from cpgisland_tpu_torch import family, pipeline
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import HmmParams, load_text
from cpgisland_tpu_torch.ops import _kernels, fb_chunked, fb_seq
from cpgisland_tpu_torch.ops import fb_compose as FC
from cpgisland_tpu_torch.ops import fb_onehot as FB
from cpgisland_tpu_torch.ops import fb_pallas as FP
from cpgisland_tpu_torch.ops import loglik as LL
from cpgisland_tpu_torch.ops import viterbi_onehot as OH
from cpgisland_tpu_torch.ops import viterbi_pallas as VP
from cpgisland_tpu_torch.ops.islands_device import DEFAULT_CAP, call_islands_device
from cpgisland_tpu_torch.ops.prepared import chunked_Tt, prepare_chunked, prepare_seq
from cpgisland_tpu_torch.parallel.decode import resolve_engine, viterbi_sharded, viterbi_sharded_spans
from cpgisland_tpu_torch.family.stacked import stack_groups
from cpgisland_tpu_torch.parallel.posterior import posterior_sharded, resolve_fb_engine
from cpgisland_tpu_torch.train import baum_welch
from cpgisland_tpu_torch.tools import bench_compose as BC
from cpgisland_tpu_torch.train.backends import FamilyEStep, LocalBackend, fit_family
from cpgisland_tpu_torch.utils import chunking, codec

BK, NB = 4096, 16384  # the default block; 64 Mi steps
FB_NL, FB_TP = 1024, chunking.TRAIN_CHUNK  # B4/B5: 1024 chunks of 65,536 steps
# The genome's training batch (clean: 1,390 chunks of 65,536) and its seq
# layout (11,121 lanes of 8,192 steps): B5's sweep runs at these too.
GENOME_CHUNKS, GENOME_SEQ_LANES = 1390, 11121
POST_NL, POST_LANE_T = 8192, fb_seq.DEFAULT_LANE_T  # B7 (and B4): a 64 Mi span
BIG_RECORD = 64 << 20
BIG_LEAD_N = 10_000  # the big record opens with an N run, as assembled chromosomes do
N_SCAFFOLDS = 256
PARITY_SYMBOLS = 4 << 20
TRAIN_ITERS = 5
# B4's sub-lane lengths timed beside the default (fb_onehot.SUBLANE_T) and
# one sub-lane (G = 1) at both of its geometries.
SWEEP_SUBLANE_T = (2048, 4096, 8192)
# B18's (fb_pallas.BWD_SUBLANE_T), likewise at K <= 4.
SWEEP_BWD_SUBLANE_T = (256, 1024, 2048, 4096, 8192)
# B10's (fb_pallas.BWD_SUBLANE_T, B18's), likewise at both of its geometries.
SWEEP_SPLIT_BWD_SUBLANE_T = (256, 512, 1024, 2048, 4096)
# B7's sub-lane lengths (fb_onehot.PROD_SUBLANE_T) timed at the posterior
# geometry beside one sub-lane.
SWEEP_PROD_SUBLANE_T = (2048, 1024, 512, 256)
# B16's (fb_pallas.FWD_SUBLANE_T), at K <= 4 at both of its geometries.
SWEEP_FWD_SUBLANE_T = (256, 512, 1024, 2048, 4096)
# B5's segment lengths (fb_onehot.STATS_SEGMENT_T) timed at the training and
# the seq geometry, beside the layout's old t-tile segments.
SWEEP_STATS_SEGMENT_T = (128, 256, 512, 1024, 2048, 4096)
# The scoring kernels' sub-lane lengths (loglik.LOGLIK_SUBLANE_T) timed beside
# the default and one sub-lane at the genome record's lanes and compare's.
SWEEP_LOGLIK_SUBLANE_T = (2048, 1024, 512, 256)
# The redesigned kernels whose ptxas registers and spills are printed.
REDESIGNED = ("oh_fwdbwd_kernel", "oh_fwdbwd_stacked_kernel", "fb_prod_kernel",
              "oh_prod_kernel", "fb_bwd_kernel", "fb_bwd_sub_kernel", "fb_fwd_kernel",
              "fb_fwd_sub_kernel", "fb_fwd_split_kernel", "fb_bwd_split_kernel",
              "oh_seq_stats_part_kernel", "oh_loglik_kernel", "oh_loglik_sub_kernel",
              "fb_loglik_kernel", "fb_loglik_sub_kernel",
              "oh_fwd_kernel", "oh_fwd_sub_kernel", "oh_bwd_kernel", "oh_bwd_sub_kernel",
              "oh_backpointers_kernel", "dense_backpointers_kernel", "oh_products_kernel",
              "oh_products_lane_kernel", "oh_backtrace_kernel", "dense_products_kernel",
              "fb_bwd_sub_conf_kernel", "fb_bwd_split_conf_kernel", "dense_backtrace_kernel")
H100_SMS, SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 132, 228 * 1024, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
# float64 operations counted for one log in the scoring kernels' bound: its
# range reduction and a polynomial of about ten terms in FMAs.
LOG_F64_OPS = 20

# name -> (the TPU kernel it replaces, its CUDA source)
KERNELS = {
    "oh_products": ("cpgisland_tpu/ops/viterbi_onehot.py:401",
                    "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backpointers": ("cpgisland_tpu/ops/viterbi_onehot.py:435",
                        "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backtrace": ("cpgisland_tpu/ops/viterbi_onehot.py:539",
                     "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backpointers_scores": ("cpgisland_tpu/ops/viterbi_onehot.py:481",
                               "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_products_stacked": ("cpgisland_tpu/ops/viterbi_onehot.py:1257",
                            "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backpointers_stacked": ("cpgisland_tpu/ops/viterbi_onehot.py:1341",
                                "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backpointers_stacked_scores": ("cpgisland_tpu/ops/viterbi_onehot.py:1341",
                                       "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backtrace_stacked": ("cpgisland_tpu/ops/viterbi_onehot.py:1519",
                             "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_prod": ("cpgisland_tpu/ops/fb_onehot.py:102",
                "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwdbwd": ("cpgisland_tpu/ops/fb_onehot.py:266",
                  "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_seq_stats": ("cpgisland_tpu/ops/fb_onehot.py:804",
                     "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwdbwd_mat": ("cpgisland_tpu/ops/fb_onehot.py:347",
                      "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwd": ("cpgisland_tpu/ops/fb_onehot.py:188", "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_bwd": ("cpgisland_tpu/ops/fb_onehot.py:221", "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_bwd_conf": ("cpgisland_tpu/ops/fb_onehot.py:492",
                    "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_stats": ("cpgisland_tpu/ops/fb_onehot.py:572", "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwd_stacked": ("cpgisland_tpu/ops/fb_onehot.py:1823",
                       "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_bwd_stacked": ("cpgisland_tpu/ops/fb_onehot.py:1871",
                       "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "dense_products": ("cpgisland_tpu/ops/viterbi_pallas.py:118",
                       "cpgisland_tpu_torch/csrc/viterbi_dense.cu"),
    "dense_backpointers": ("cpgisland_tpu/ops/viterbi_pallas.py:156",
                           "cpgisland_tpu_torch/csrc/viterbi_dense.cu"),
    "dense_backtrace": ("cpgisland_tpu/ops/viterbi_pallas.py:213",
                        "cpgisland_tpu_torch/csrc/viterbi_dense.cu"),
    "fb_fwd": ("cpgisland_tpu/ops/fb_pallas.py:201", "cpgisland_tpu_torch/csrc/fb_dense.cu"),
    "fb_prod": ("cpgisland_tpu/ops/fb_pallas.py:241", "cpgisland_tpu_torch/csrc/fb_dense.cu"),
    "fb_bwd": ("cpgisland_tpu/ops/fb_pallas.py:303", "cpgisland_tpu_torch/csrc/fb_dense.cu"),
    "fb_bwd_conf": ("cpgisland_tpu/ops/fb_pallas.py:366",
                    "cpgisland_tpu_torch/csrc/fb_dense.cu"),
    "fb_stats": ("cpgisland_tpu/ops/fb_pallas.py:535", "cpgisland_tpu_torch/csrc/fb_dense.cu"),
    "oh_prod_stacked": ("cpgisland_tpu/ops/fb_onehot.py:1695",
                        "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwdbwd_stacked": ("cpgisland_tpu/ops/fb_onehot.py:1930",
                          "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_seq_stats_stacked": ("cpgisland_tpu/ops/fb_onehot.py:2323",
                             "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    # The pair-composition bench's variants (T1 is B9).
    "oh_fwd_strm": ("tools/bench_compose.py:135", "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwd_comp": ("tools/bench_compose.py:205", "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_fwd_compsel": ("tools/bench_compose.py:300", "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    # The scoring pass has no Pallas kernel: it replaces the serial lax.scan of
    # sequence_loglik.
    "oh_loglik": ("cpgisland_tpu/ops/forward_backward.py:316",
                  "cpgisland_tpu_torch/csrc/loglik.cu"),
    "fb_loglik": ("cpgisland_tpu/ops/forward_backward.py:316",
                  "cpgisland_tpu_torch/csrc/loglik.cu"),
}
DECODE_KERNELS = ("oh_products", "oh_backpointers", "oh_backtrace")
# The stacked decode: B26, B27 (path arm, scores arm) and B28.
STACKED_DECODE_KERNELS = ("oh_products_stacked", "oh_backpointers_stacked",
                          "oh_backpointers_stacked_scores", "oh_backtrace_stacked")
DENSE_KERNELS = ("dense_products", "dense_backpointers", "dense_backtrace")
TRAIN_KERNELS = ("oh_fwdbwd", "oh_seq_stats")
POSTERIOR_KERNELS = ("oh_prod", "oh_fwdbwd")
DENSE_TRAIN_KERNELS = ("fb_fwd", "fb_bwd", "fb_stats")
DENSE_FB_KERNELS = ("fb_fwd", "fb_prod", "fb_bwd", "fb_bwd_conf", "fb_stats")
ISLAND_STATES = (0, 1, 2, 3)
# (label, span, B7 launches): the big record in one pass (the scaffolds
# batch, without B7), then in 4 spans (4 transfer totals, 4 posteriors).
POSTERIOR_RUNS = (("default", 1 << 26, 1), ("span16Mi", 1 << 24, 8))
# (S, M) of the stacked kernel checks: the flagship (S=4) or dinuc_cpg (S=16)
# plus M-1 random partition=2 members of its alphabet.
STACK_CONFIGS = ((4, 2), (4, 5), (16, 2))
STACKED_KERNELS = ("oh_prod_stacked", "oh_fwdbwd_stacked", "oh_seq_stats_stacked")
SINGLE_FB_KERNELS = ("oh_prod", "oh_fwdbwd", "oh_seq_stats")
FAMILY_M = 3
SEQ_KERNELS = ("oh_prod", "oh_fwdbwd", "oh_seq_stats")  # the two-pass seq E-step
ONE_PASS_KERNELS = ("oh_fwdbwd_mat", "oh_seq_stats")
DENSE_SEQ_KERNELS = ("fb_prod", "fb_fwd", "fb_bwd")
# The JAX one-pass tests' bound (tests/test_one_pass.py): loglik rel 1e-5,
# the trained model within atol 1e-5.
ONE_PASS_LL_RTOL, MODEL_ATOL = 1e-5, 1e-5
# The split arm (fused=False): its chunked E-step, its whole-sequence
# E-step, and the fused arm's kernels it must never launch.
SPLIT_TRAIN_KERNELS = ("oh_fwd", "oh_bwd", "oh_stats")
SPLIT_SEQ_KERNELS = ("oh_prod", "oh_fwd", "oh_bwd", "oh_seq_stats")
FUSED_CHAINS = ("oh_fwdbwd", "oh_fwdbwd_stacked", "oh_fwdbwd_mat")
SPLIT_STACK_M = (2, 5)
# The stacked kernels' plain versions run at these M only: at M = 5 each
# member is held bit for bit against the single-model kernel, itself held
# to its own plain version in the same run.
PLAIN_STACK_M = (2,)
# The split arm's bounds against the fused arm (tests/test_passfusion.py):
# confidence atol 2e-5, logliks rtol 1e-5, MPM paths equal.
SPLIT_CONF_ATOL, SPLIT_LL_RTOL = 2e-5, 1e-5
# compare's casts run on the big record's first COMPARE_SYMBOLS plus
# COMPARE_SCAFFOLDS scaffolds (the genome's 257 records cost ~170 s).
COMPARE_SYMBOLS, COMPARE_SCAFFOLDS = 8 << 20, 16
# The mixed-model flush unit: the flagship plus M - 1 random partition=2
# members, over decode_file's flushes of the genome's scaffolds (its
# device_batch of 8 records a flush).
FLUSH_M, FLUSH_RECORDS, PROFILED_FLUSHES = (2, 3), 8, 8


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line is stamped with the seconds since the
    script started (the kernel table and the ok line carry only their own
    keys)."""
    if "phase" in obj:
        obj = obj | {"t_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``runs`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x.double() - y.double()).abs().max())


def max_rel_diff(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(((x.double() - y.double()).abs() / y.double().abs().clamp_min(1e-30)).max())


def ptxas_of(names) -> dict:
    """Kernel (mangled name) -> ptxas's registers and spills, for every
    built kernel whose name contains one of ``names``."""
    out = {}
    for rep in _kernels.build_info.get("nvcc_report", {}).values():
        lines = rep.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(n in ln for n in names):
                fn = ln.split("'")[1]
                info = [x.split("info    :")[-1].strip() for x in lines[i + 2 : i + 4]]
                out[fn] = " | ".join(info)
    return out


@contextlib.contextmanager
def patched(module, **values):
    """The module's attributes set to ``values`` inside the block."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def sublane_length(st: int):
    """B4 / B24 with sub-lanes of ``st`` steps (``fb_onehot.SUBLANE_T``)
    inside the block; ``st`` = the lane length gives one sub-lane."""
    return patched(FB, SUBLANE_T=st)


def bwd_sublane_length(st: int):
    """B18 at K <= 4, and B10 / B23, with sub-lanes of ``st`` steps
    (``fb_pallas.BWD_SUBLANE_T``; lanes of 8 Ki steps or more); ``st`` =
    the lane length gives one."""
    return patched(FP, BWD_SUBLANE_T=st)


def fwd_sublane_length(st: int):
    """B16 at K <= 4 with sub-lanes of ``st`` steps
    (``fb_pallas.FWD_SUBLANE_T``; lanes of 8 Ki steps or more); ``st`` =
    the lane length gives one."""
    return patched(FP, FWD_SUBLANE_T=st)


def stats_segment_length(st: int):
    """B5 / B25 with segments of ``st`` steps (``fb_onehot.STATS_SEGMENT_T``)."""
    return patched(FB, STATS_SEGMENT_T=st)


def loglik_sublane_length(st: int):
    """The scoring kernels with sub-lanes of ``st`` steps
    (``loglik.LOGLIK_SUBLANE_T``; lanes of 8 Ki steps or more); ``st`` = the
    lane length gives one."""
    return patched(LL, LOGLIK_SUBLANE_T=st)


def prod_sublane_length(st: int):
    """B7 / B21 with sub-lanes of ``st`` steps (``fb_onehot.PROD_SUBLANE_T``;
    lanes of 8 Ki steps or more); ``st`` = the lane length gives one."""
    return patched(FB, PROD_SUBLANE_T=st)


def sublane_sweep(args) -> dict:
    """B4 on ``args`` in one sub-lane (G = 1: held bit for bit against its
    plain version, timed) and at each SWEEP_SUBLANE_T (timed, with its
    largest relative difference from G = 1)."""
    Tp = args[0].shape[0]
    with sublane_length(Tp):
        al1, be1 = FB.oh_fwdbwd(*args)
        (al_p, be_p), g1_plain_ms = timed_once(lambda: FB.oh_fwdbwd_plain(*args))
        g1_equal = torch.equal(al1, al_p) and torch.equal(be1, be_p)
        del al_p, be_p
        g1_ms = time_ms(lambda: FB.oh_fwdbwd(*args), runs=10)
    sweep = {}
    for st in SWEEP_SUBLANE_T:
        with sublane_length(st):
            al, be = FB.oh_fwdbwd(*args)
            sweep[str(st)] = {
                "G": FB.sublanes(Tp), "ms": time_ms(lambda: FB.oh_fwdbwd(*args), runs=10),
                "max_rel_vs_g1": max(max_rel_diff(al, al1), max_rel_diff(be, be1))}
        del al, be
    return {"g1_bit_equal": g1_equal, "g1_plain_ms": g1_plain_ms, "g1_ms": g1_ms,
            "sweep": sweep}


def prod_sweep(pair2, tab) -> dict:
    """B7 on ``pair2`` in one sub-lane (G = 1: held bit for bit against its
    plain version, timed) and at each SWEEP_PROD_SUBLANE_T (timed, with its
    largest relative difference from G = 1)."""
    Tp = pair2.shape[0]
    with prod_sublane_length(Tp):
        red1 = FB.oh_prod(pair2, tab)
        red_p, g1_plain_ms = timed_once(lambda: FB.oh_prod_plain(pair2, tab))
        g1_equal = torch.equal(red1, red_p)
        g1_ms = time_ms(lambda: FB.oh_prod(pair2, tab), runs=10)
    sweep = {}
    for st in SWEEP_PROD_SUBLANE_T:
        with prod_sublane_length(st):
            red = FB.oh_prod(pair2, tab)
            sweep[str(st)] = {
                "G": FB.prod_sublanes(Tp), "ms": time_ms(lambda: FB.oh_prod(pair2, tab), runs=10),
                "max_rel_vs_g1": max_rel_diff(red, red1)}
    return {"g1_bit_equal": g1_equal, "g1_plain_ms": g1_plain_ms, "g1_ms": g1_ms,
            "sweep": sweep}


def fwd_sweep(args, K: int) -> dict:
    """At K <= 4, B16 on ``args`` in one sub-lane (G = 1: held bit for bit
    against its plain version, timed) and at each SWEEP_FWD_SUBLANE_T
    (timed, with the largest relative difference from G = 1); at K >= 5
    nothing: every lane is one chain (state-split), the row itself."""
    if K > FP.BWD_SUBLANE_MAX_K:
        return {}
    Tp = args[0].shape[0]
    with fwd_sublane_length(Tp):
        al1 = FP.fb_fwd(*args)
        al_p, g1_plain_ms = timed_once(lambda: FP.fb_fwd_plain(*args))
        g1_equal = torch.equal(al1, al_p)
        del al_p
        g1_ms = time_ms(lambda: FP.fb_fwd(*args), runs=10)
    sweep = {}
    for st in SWEEP_FWD_SUBLANE_T:
        with fwd_sublane_length(st):
            al = FP.fb_fwd(*args)
            sweep[str(st)] = {
                "G": FP.fwd_sublanes(Tp, K), "ms": time_ms(lambda: FP.fb_fwd(*args), runs=10),
                "max_rel_vs_g1": max_rel_diff(al, al1)}
            del al
    return {"g1_bit_equal": g1_equal, "g1_plain_ms": g1_plain_ms, "g1_ms": g1_ms,
            "sweep": sweep}


def kernel_split_ms(fn, names, runs: int = 10) -> dict:
    """Device ms a call of ``fn`` spends in the kernels whose names contain
    each of ``names`` (torch.profiler over ``runs`` warm calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {n: None for n in names}  # None: the profiler recorded no such kernel
    for key, us, _ in device_rows(prof):
        for n in names:
            if n in key:
                out[n] = (out[n] or 0.0) + us / 1e3 / runs
    return out


def stats_occupancy(Tp: int, NL: int, S: int) -> dict:
    """B5's launch at this shape: blocks of the part kernel, the blocks an
    SM holds as its shared memory (the accumulator columns plus the static
    tables) and its registers allow, from ptxas's report, and the waves
    over the card's SMs."""
    spb = FB.stats_segments_per_block(S)
    reports = list(ptxas_of(("oh_seq_stats_part_kernel",)).values())
    if not reports:  # the kernels were built by an earlier process
        return {"threads": 32 * spb, "blocks": -(-NL // 32) * FB._stats_part_rows(Tp, NL, S)}
    static = int(reports[0].split(" bytes smem")[0].rsplit(" ", 1)[-1])
    regs = int(reports[0].split(" registers")[0].rsplit(" ", 1)[-1])
    smem = (4 * S * S + 2 * S + 1) * 32 * spb * 4 + static
    warp_regs = -(-regs * 32 // 256) * 256  # registers go to a warp 256 at a time
    per_sm = min(SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED), 2048 // (32 * spb), 32,
                 65536 // (warp_regs * spb))
    blocks = -(-NL // 32) * FB._stats_part_rows(Tp, NL, S)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"threads": 32 * spb, "smem_bytes": smem, "registers": regs, "blocks": blocks,
            "blocks_per_sm": per_sm,
            "waves": blocks / (sms * per_sm), "sms": sms}


def stats_sweep(args, want, old_Tt: int) -> dict:
    """B5 on ``args`` at each SWEEP_STATS_SEGMENT_T and at the layout's old
    segment ``old_Tt``: the part and the reduce kernel timed apart
    (torch.profiler), the whole call (CUDA events), the launch geometry,
    and agreement with the plain version's ``want`` (rtol 1e-5 / atol
    1e-3); at the default segment two launches must give the same bits."""
    Tp, NL = args[2].shape
    S = args[6].shape[0]
    out = {}
    for st in sorted(set(SWEEP_STATS_SEGMENT_T) | {old_Tt}):
        with stats_segment_length(st):
            got = FB.oh_seq_stats(*args)
            split = kernel_split_ms(lambda: FB.oh_seq_stats(*args),
                                    ("oh_seq_stats_part", "oh_seq_stats_reduce"))
            out[str(st)] = {
                "ms": time_ms(lambda: FB.oh_seq_stats(*args), runs=10),
                "part_ms": split["oh_seq_stats_part"], "reduce_ms": split["oh_seq_stats_reduce"],
                "agrees": all(torch.allclose(g, w, rtol=1e-5, atol=1e-3)
                              for g, w in zip(got, want)),
                **stats_occupancy(Tp, NL, S)}
    first, again = FB.oh_seq_stats(*args), FB.oh_seq_stats(*args)
    return {"segment_t": FB.stats_segment_t(Tp, NL), "old_Tt": old_Tt,
            "two_launches_equal": all(torch.equal(a, b) for a, b in zip(first, again)),
            "sweep": out}


def bwd_sweep(args, K: int) -> dict:
    """At K <= 4, B18 on ``args`` in one sub-lane (G = 1: held bit for bit
    against its plain version, timed) and at each SWEEP_BWD_SUBLANE_T
    (timed, with the largest relative difference from G = 1); at K >= 5
    nothing, as :func:`fwd_sweep`."""
    if K > FP.BWD_SUBLANE_MAX_K:
        return {}
    Tp = args[0].shape[0]
    with bwd_sublane_length(Tp):
        be1 = FP.fb_bwd(*args)
        be_p, g1_plain_ms = timed_once(lambda: FP.fb_bwd_plain(*args))
        g1_equal = torch.equal(be1, be_p)
        del be_p
        g1_ms = time_ms(lambda: FP.fb_bwd(*args), runs=10)
    sweep = {}
    for st in SWEEP_BWD_SUBLANE_T:
        with bwd_sublane_length(st):
            be = FP.fb_bwd(*args)
            sweep[str(st)] = {
                "G": FP.bwd_sublanes(Tp, K), "ms": time_ms(lambda: FP.fb_bwd(*args), runs=10),
                "max_rel_vs_g1": max_rel_diff(be, be1)}
            del be
    return {"g1_bit_equal": g1_equal, "g1_plain_ms": g1_plain_ms, "g1_ms": g1_ms,
            "sweep": sweep}


# ---------------------------------------------------------------------------
# Phase 2: the kernels at full size


def kernel_phase(rng: np.random.Generator, params, dev) -> dict:
    S = params.n_symbols
    steps = rng.integers(0, S, size=(BK, NB)).astype(np.int32)
    # PAD runs along the time axis (masked N runs), and sparse record resets.
    starts = rng.integers(0, BK, size=NB // 4)
    lanes = rng.integers(0, NB, size=NB // 4)
    lens = rng.integers(1, 200, size=NB // 4)
    for k0, b, n in zip(starts, lanes, lens):
        steps[k0 : k0 + n, b] = S
    resets = rng.random((BK, NB)) < 1e-4
    steps_d = torch.from_numpy(steps).to(dev)
    resets_d = torch.from_numpy(resets).to(dev)
    pre = OH.prepare_pairs(S, steps_d, 1, resets_d)
    _, _, tab, idtab, pair2, _, _, nreal = OH._prepared(params, steps_d, 1, resets_d, pre)
    assert nreal == S * S + S and pair2.shape == (BK, NB)
    v = rng.normal(scale=3.0, size=(2, NB)).astype(np.float32)
    v_red = torch.from_numpy(v - v.max(axis=0, keepdims=True)).to(dev)
    exit_bits = torch.from_numpy(rng.integers(0, 2, size=NB).astype(np.int32)).to(dev)
    tab, idtab = tab.contiguous(), idtab.contiguous()

    results = {}
    steps_n = BK * NB
    # (kernel call, plain call, bytes moved, f32 operations)
    # Each plain version runs once: its output is the reference, its
    # device time the plain_ms of the row.
    plain_ms = {}
    red_k = OH.oh_products(pair2, tab)
    red_p, plain_ms["oh_products"] = timed_once(lambda: OH.oh_products_plain(pair2, tab))
    bp_k, de_k, eb_k = OH.oh_backpointers(pair2, v_red, tab)
    (bp_p, de_p, eb_p), plain_ms["oh_backpointers"] = timed_once(
        lambda: OH.oh_backpointers_plain(pair2, v_red, tab))
    path_k = OH.oh_backtrace(bp_k, pair2, idtab, exit_bits)
    path_p, plain_ms["oh_backtrace"] = timed_once(
        lambda: OH.oh_backtrace_plain(bp_p, pair2, idtab, exit_bits))
    # B6 on the same flat stream: bit-equal to its plain version on every
    # output, and its first three outputs to B2's launch (B2 re-checked).
    sc_k = OH.oh_backpointers_scores(pair2, v_red, tab)
    sc_p, plain_ms["oh_backpointers_scores"] = timed_once(
        lambda: OH.oh_backpointers_scores_plain(pair2, v_red, tab))
    checks = {
        "oh_products": [(red_k, red_p)],
        "oh_backpointers": [(bp_k, bp_p), (de_k, de_p), (eb_k, eb_p)],
        "oh_backtrace": [(path_k, path_p)],
        "oh_backpointers_scores": list(zip(sc_k, sc_p)) + list(zip(sc_k[:3], (bp_k, de_k, eb_k))),
    }
    tab_b, id_b = tab.numel() * 4, idtab.numel() * 4
    bytes_moved = {
        "oh_products": 4 * steps_n + tab_b + 16 * NB,
        "oh_backpointers": 4 * steps_n + 8 * NB + tab_b + steps_n // 2 + 8 * NB + 4 * NB,
        "oh_backtrace": steps_n // 2 + 4 * steps_n + id_b + 4 * NB + 4 * steps_n,
        # B2's bytes plus the [bk, nb] f32 chain max
        "oh_backpointers_scores": (4 * steps_n + 8 * NB + tab_b + steps_n // 2 + 8 * NB
                                   + 4 * NB + 4 * steps_n),
    }
    ops = {  # adds + maxes per step (compares and bit ops counted as ops)
        "oh_products": 12 * steps_n,
        "oh_backpointers": 14 * steps_n,
        "oh_backtrace": 3 * steps_n,
        "oh_backpointers_scores": 15 * steps_n,
    }
    calls = {
        "oh_products": lambda: OH.oh_products(pair2, tab),
        "oh_backpointers": lambda: OH.oh_backpointers(pair2, v_red, tab),
        "oh_backtrace": lambda: OH.oh_backtrace(bp_k, pair2, idtab, exit_bits),
        "oh_backpointers_scores": lambda: OH.oh_backpointers_scores(pair2, v_red, tab),
    }
    for name, pairs in checks.items():
        equal = all(torch.equal(a, b) for a, b in pairs)
        err = max(max_abs_err(a, b) for a, b in pairs)
        extra = {}
        if name == "oh_backpointers_scores":
            extra = {"b2_ms": results["oh_backpointers"]["ms"]}
        results[name] = kernel_row(name, equal, err, calls[name], plain_ms[name],
                                   bytes_moved[name], ops[name], steps_n, bit_equal=equal,
                                   **extra)
        if not equal:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return results


def timed_once(fn):
    """(result, device ms) of one call of ``fn``: for the plain versions,
    whose one call both times them and gives the reference output."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def plain_once(run: bool, fn):
    """timed_once(fn) where ``run``, else (None, None): a stacked kernel's
    plain version runs at M = 2 only (PLAIN_STACK_M); at M = 5 each member
    is held against the single-model kernel instead."""
    return timed_once(fn) if run else (None, None)


def kernel_row(name, agree, err, kernel_fn, plain_ms, n_bytes, n_ops, steps, **extra) -> dict:
    """Time a kernel (median of 10) beside its plain version's time (from
    the one run that gave the reference output), add the bound, print the
    row and return it."""
    ms = time_ms(kernel_fn, runs=10)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    replaces, source = KERNELS[name]
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "agrees": agree, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "bytes": n_bytes, "steps": steps, **extra,
    }
    emit({"phase": "kernel", **row})
    return row


def ragged_chunks(rng: np.random.Generator, S: int, NL: int = FB_NL):
    """NL chunks of FB_TP symbols, a quarter of them cut short and the
    last one to a fifth, PAD past each length."""
    chunks = rng.integers(0, S, size=(NL, FB_TP)).astype(np.uint8)
    lengths = np.full(NL, FB_TP, np.int32)
    lengths[-1] = FB_TP // 5
    ragged = rng.random(NL) < 0.25
    lengths[:-1][ragged[:-1]] = rng.integers(1, FB_TP, size=int(ragged[:-1].sum()))
    chunks[np.arange(FB_TP)[None, :] >= lengths[:, None]] = S
    return chunks, lengths


def seq_stats_main_shapes(params, dev) -> None:
    """B5's rows and segment sweeps at the main path's own shapes: the
    genome's training batch (GENOME_CHUNKS ragged chunks of FB_TP steps,
    zero enters) and its ``seq`` layout (GENOME_SEQ_LANES lanes of
    POST_LANE_T steps, random enters, every lane's t == 0 pair but lane
    0's), on B4's streams; a generator of its own, so the genome's draw
    is unchanged."""
    own = np.random.default_rng(6)
    S, K = params.n_symbols, params.n_states
    gt = OH._groups(params)
    tab = FB.prob_tab_ext(params, gt)
    B_red, gt32 = FB.reduced_emissions(params, gt), gt.to(torch.int32).contiguous()
    chunks, lengths = ragged_chunks(own, S, GENOME_CHUNKS)
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                           torch.from_numpy(lengths).to(dev), t_tile=fb_chunked.DEFAULT_T_TILE)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    al, be = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, FB_TP)
    NL = GENOME_CHUNKS
    zeros = lambda rows: torch.zeros((rows, NL), dtype=torch.float32, device=dev)  # noqa: E731
    seq_stats_row((al, be, prep.pair2, prep.lens2, tab, B_red, gt32, zeros(K), zeros(2),
                   zeros(1)), int(np.minimum(lengths, FB_TP).sum()), prep.Tt,
                  geometry=f"train, {NL} chunks")
    del al, be, prep, chunks
    NL = GENOME_SEQ_LANES
    obs = torch.from_numpy(own.integers(0, S, size=NL * POST_LANE_T).astype(np.uint8)).to(dev)
    prep = prepare_seq(S, obs, NL * POST_LANE_T - POST_LANE_T // 3, lane_T=POST_LANE_T)
    lens2 = prep.lane_lens[None, :].contiguous()
    ent = lambda rows: torch.from_numpy(  # noqa: E731
        own.random((rows, NL)).astype(np.float32) + 0.01).to(dev)
    al, be = FB.oh_fwdbwd(prep.pair2, prep.pairn2, lens2, ent(2), ent(2), tab, POST_LANE_T)
    pair0 = torch.ones((1, NL), dtype=torch.float32, device=dev)
    pair0[0, 0] = 0.0
    seq_stats_row((al, be, prep.pair2, lens2, tab, B_red, gt32, ent(K), ent(2), pair0),
                  int(prep.lane_lens.sum()), chunked_Tt(POST_LANE_T, fb_chunked.DEFAULT_T_TILE),
                  geometry=f"seq lanes, {NL}")
    del al, be, prep, obs
    torch.cuda.empty_cache()


def fb_kernel_phase(rng: np.random.Generator, params, dev) -> dict:
    """B4 and B5 at the training path's shapes: NL chunks of Tp = 65,536
    steps, ragged lengths (a short last lane, PAD tails), the flagship
    model's tables; B5 with the chunked caller's zero enters and pair0
    mask."""
    K, S = params.n_states, params.n_symbols
    chunks, lengths = ragged_chunks(rng, S)
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                           torch.from_numpy(lengths).to(dev), t_tile=fb_chunked.DEFAULT_T_TILE)
    gt = OH._groups(params)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    tab = FB.prob_tab_ext(params, gt)
    fb_args = (prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, FB_TP)
    al_k, be_k = FB.oh_fwdbwd(*fb_args)
    (al_p, be_p), fb_plain_ms = timed_once(lambda: FB.oh_fwdbwd_plain(*fb_args))
    equal = torch.equal(al_k, al_p) and torch.equal(be_k, be_p)
    err = max(max_abs_err(al_k, al_p), max_abs_err(be_k, be_p))
    del al_p, be_p
    Tp, NL = prep.pair2.shape
    steps_n = Tp * NL
    sweep = sublane_sweep(fb_args)
    results = {"oh_fwdbwd": kernel_row(
        "oh_fwdbwd", equal, err, lambda: FB.oh_fwdbwd(*fb_args), fb_plain_ms,
        # pair + pairn read, alphas + betas written, per step
        n_bytes=8 * steps_n + 16 * steps_n + 4 * NL + 16 * NL + tab.numel() * 4,
        n_ops=2 * 7 * steps_n, steps=steps_n, bit_equal=equal, sublanes=FB.sublanes(Tp),
        **sweep,
    )}
    if not (equal and sweep["g1_bit_equal"]):
        raise SystemExit("chip_smoke: oh_fwdbwd disagrees with its plain version")

    assert not torch.backends.cuda.matmul.allow_tf32
    B_red = params.B[gt, torch.arange(S, device=dev)[:, None]].contiguous()
    zeros = lambda rows: torch.zeros((rows, NL), dtype=torch.float32, device=dev)
    st_args = (al_k, be_k, prep.pair2, prep.lens2, tab, B_red,
               gt.to(torch.int32).contiguous(), zeros(K), zeros(2), zeros(1))
    valid = int(np.minimum(lengths, Tp).sum())  # B5 reads valid steps only
    results["oh_seq_stats"] = seq_stats_row(st_args, valid, prep.Tt, geometry="train")
    return results


def seq_stats_row(st_args, valid: int, old_Tt: int, **extra) -> dict:
    """B5 on ``st_args`` held within rtol 1e-5 / atol 1e-3 of its plain
    version, timed, with its segment sweep (:func:`stats_sweep`); raises on
    a disagreement."""
    K, NL = st_args[7].shape
    S = st_args[6].shape[0]
    got = FB.oh_seq_stats(*st_args)
    want, st_plain_ms = timed_once(lambda: FB.oh_seq_stats_plain(*st_args))
    agree = all(torch.allclose(g, w, rtol=1e-5, atol=1e-3) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    sweep = stats_sweep(st_args, want, old_Tt)
    del want
    row = kernel_row(
        "oh_seq_stats", agree, err, lambda: FB.oh_seq_stats(*st_args), st_plain_ms,
        n_bytes=20 * valid + 4 * NL + (K * K + 2 * S + 1) * NL * 4,
        n_ops=40 * valid, steps=valid, tolerance="rtol 1e-5, atol 1e-3", **sweep, **extra,
    )
    if not (agree and sweep["two_launches_equal"]
            and all(v["agrees"] for v in sweep["sweep"].values())):
        raise SystemExit(f"chip_smoke: oh_seq_stats disagrees with its plain version "
                         f"({extra}) or between two launches")
    return row


def post_kernel_phase(rng: np.random.Generator, params, dev) -> dict:
    """B7 at the posterior's geometry: one 64 Mi span laid out as POST_NL
    lanes of POST_LANE_T steps, its last lane short (a PAD tail).  B4 is
    held and timed again on the same lanes (a whole-sequence span: few,
    long chains)."""
    S = params.n_symbols
    T = POST_NL * POST_LANE_T
    length = T - POST_LANE_T // 3
    obs = torch.from_numpy(rng.integers(0, S, size=T).astype(np.uint8)).to(dev)
    prep = prepare_seq(S, obs, length, lane_T=POST_LANE_T)
    Tp, NL = prep.pair2.shape
    assert (Tp, NL) == (POST_LANE_T, POST_NL)
    tab = FB.prob_tab_ext(params, OH._groups(params))
    red_k = FB.oh_prod(prep.pair2, tab)
    red_p, prod_plain_ms = timed_once(lambda: FB.oh_prod_plain(prep.pair2, tab))
    equal = torch.equal(red_k, red_p)
    steps_n = Tp * NL
    sweep = prod_sweep(prep.pair2, tab)
    results = {"oh_prod": kernel_row(
        "oh_prod", equal, max_abs_err(red_k, red_p), lambda: FB.oh_prod(prep.pair2, tab),
        prod_plain_ms,
        # the pair stream read, [4, NL] written; per step 8 multiplies and 4
        # adds, and every 8th step a renormalization (3 adds, a max, a
        # division, 4 multiplies)
        n_bytes=4 * steps_n + tab.numel() * 4 + 16 * NL, n_ops=13 * steps_n,
        steps=steps_n, bit_equal=equal, sublanes=FB.prod_sublanes(Tp), **sweep,
    )}
    if not (equal and sweep["g1_bit_equal"]):
        raise SystemExit("chip_smoke: oh_prod disagrees with its plain version")

    lens2 = prep.lane_lens[None, :].contiguous()
    v = lambda: torch.from_numpy(rng.random((2, NL)).astype(np.float32) + 0.01).to(dev)
    fb_args = (prep.pair2, prep.pairn2, lens2, v(), v(), tab, POST_LANE_T)
    al_k, be_k = FB.oh_fwdbwd(*fb_args)
    (al_p, be_p), fb_plain_ms = timed_once(lambda: FB.oh_fwdbwd_plain(*fb_args))
    equal = torch.equal(al_k, al_p) and torch.equal(be_k, be_p)
    err = max(max_abs_err(al_k, al_p), max_abs_err(be_k, be_p))
    del al_p, be_p
    sweep = sublane_sweep(fb_args)
    kernel_row(
        "oh_fwdbwd", equal, err, lambda: FB.oh_fwdbwd(*fb_args), fb_plain_ms,
        n_bytes=24 * steps_n + 4 * NL + 16 * NL + tab.numel() * 4, n_ops=2 * 7 * steps_n,
        steps=steps_n, bit_equal=equal, geometry="posterior span", sublanes=FB.sublanes(Tp),
        **sweep,
    )
    if not (equal and sweep["g1_bit_equal"]):
        raise SystemExit("chip_smoke: oh_fwdbwd disagrees with its plain version at the "
                         "posterior geometry")
    # B5 at the seq geometry on those streams: random entering messages, the
    # pair0 mask of the whole-sequence caller (every lane but lane 0).
    own = np.random.default_rng(5)  # ``rng`` reaches the genome unchanged
    K = params.n_states
    gt = OH._groups(params)
    ent = lambda rows: torch.from_numpy(  # noqa: E731
        own.random((rows, NL)).astype(np.float32) + 0.01).to(dev)
    pair0 = torch.ones((1, NL), dtype=torch.float32, device=dev)
    pair0[0, 0] = 0.0
    st_args = (al_k, be_k, prep.pair2, lens2, tab, FB.reduced_emissions(params, gt),
               gt.to(torch.int32).contiguous(), ent(K), ent(2), pair0)
    seq_stats_row(st_args, int(prep.lane_lens.sum()),
                  chunked_Tt(POST_LANE_T, fb_chunked.DEFAULT_T_TILE), geometry="seq lanes")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the main path on a seeded chromosome-sized FASTA

_BG = np.array([0.295, 0.205, 0.205, 0.295])  # GC 0.41
_ISLAND = np.array([0.175, 0.325, 0.325, 0.175])  # GC 0.65
_STRONG_ISLAND = np.array([0.1, 0.4, 0.4, 0.1])  # GC 0.8: one call, never split


def make_sequence(rng: np.random.Generator, n: int) -> np.ndarray:
    """Background at GC ~0.41 with CpG depleted (3 of 4 CG -> CA) and
    planted CpG-rich segments of 0.5-3 kb, about one per 50 kb."""
    s = rng.choice(4, size=n, p=_BG).astype(np.uint8)
    cg = np.flatnonzero((s[:-1] == 1) & (s[1:] == 2))
    drop = cg[rng.random(cg.size) < 0.75]
    s[drop + 1] = 0
    n_isl = max(1, n // 50_000)
    lens = rng.integers(500, 3001, size=n_isl)
    starts = rng.integers(0, max(1, n - 3000), size=n_isl)
    for a, m in zip(starts, lens):
        s[a : a + m] = rng.choice(4, size=min(m, n - a), p=_ISLAND)
    return s


def to_fasta_bytes(rng: np.random.Generator, name: str, s: np.ndarray, lead_n: int = 0) -> bytes:
    """One FASTA record, 60 bases a line, with soft-masked (lowercase) runs
    and N runs over about 1% of the record, after ``lead_n`` leading Ns."""
    text = np.concatenate([np.full(lead_n, ord("N"), np.uint8),
                           np.frombuffer(b"ACGT", np.uint8)[s]])
    n = text.size
    for a in rng.integers(0, n, size=max(1, n // 200_000)):
        text[a : a + int(rng.integers(100, 5000))] += 32  # lowercase
    for a in rng.integers(0, n, size=max(1, n // 1_000_000)):
        text[a : a + int(rng.integers(100, 10_000))] = ord("N")
    full = n // 60
    lines = np.concatenate(
        [text[: full * 60].reshape(full, 60), np.full((full, 1), ord("\n"), np.uint8)],
        axis=1,
    ).ravel()
    tail = text[full * 60 :]
    body = lines.tobytes() + (tail.tobytes() + b"\n" if tail.size else b"")
    return f">{name} synthetic\n".encode() + body


def write_fasta(rng: np.random.Generator, path: str) -> np.ndarray:
    big = make_sequence(rng, BIG_RECORD)
    with open(path, "wb") as f:
        f.write(to_fasta_bytes(rng, "chr1", big, lead_n=BIG_LEAD_N))
        sizes = np.exp(rng.uniform(np.log(2 << 10), np.log(512 << 10), size=N_SCAFFOLDS))
        for i, m in enumerate(sizes.astype(np.int64)):
            f.write(to_fasta_bytes(rng, f"scaffold{i}", make_sequence(rng, int(m))))
    return big


def check_calls(res, label: str) -> None:
    c = res.calls
    if len(c) == 0:
        raise SystemExit(f"chip_smoke: {label} decode called no islands")
    ok = (
        np.all(np.isfinite(c.gc_content)) and np.all(np.isfinite(c.oe_ratio))
        and np.all(c.beg >= 1) and np.all(c.end >= c.beg)
        and np.all(c.length == c.end - c.beg + 1)
        and np.all(c.gc_content > 0.5) and np.all(c.oe_ratio > 0.6)
    )
    if not ok:
        raise SystemExit(f"chip_smoke: {label} island calls are malformed")


def main_path_phase(rng: np.random.Generator, params, tmp: str, dev):
    fa = os.path.join(tmp, "genome.fa")
    t0 = time.perf_counter()
    big = write_fasta(rng, fa)
    emit({"phase": "fasta", "bytes": os.path.getsize(fa),
          "seconds": time.perf_counter() - t0})
    _kernels.reset_launches()
    for label, compat in (("clean", False), ("compat", True)):
        out = os.path.join(tmp, f"islands.{label}.device.txt" if not compat
                           else f"islands.{label}.txt")
        t0 = time.perf_counter()
        res = pipeline.decode_file(fa, params, islands_out=out, compat=compat, device=dev)
        wall = time.perf_counter() - t0
        check_calls(res, label)
        emit({
            "phase": "main_path", "mode": label, "symbols": res.n_symbols,
            "records_or_chunks": res.n_chunks, "islands": len(res.calls),
            "wall_s": wall, "phases_s": res.phases,
            "msym_per_s": res.n_symbols / wall / 1e6,
            "decode_msym_per_s": res.n_symbols / res.phases["decode"] / 1e6,
        })
    launches = dict(_kernels.launches)
    emit({"phase": "launches", "path": "decode", **launches})
    missing = [k for k in DECODE_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: the decode path never launched {missing}")
    return fa, big, launches


# ---------------------------------------------------------------------------
# Phase 4: the training main path on the same FASTA


def train_phase(params, fa: str, dev, kernels=TRAIN_KERNELS, absent=DENSE_TRAIN_KERNELS,
                engine: str = "auto", modes=(("compat", True), ("clean", False)),
                model: str = "durbin8", backend="local"):
    """train_file in each mode, TRAIN_ITERS iterations with convergence 0
    (fixed work), through ``backend`` (a name or an instance): each of
    ``kernels`` must launch once per iteration and none of ``absent``.
    Returns (launches over the modes, logliks by mode)."""
    launches = {k: 0 for k in kernels}
    logliks = {}
    for label, compat in modes:
        symbols = chunking.frame(
            codec.encode_file(fa, skip_headers=not compat), chunking.TRAIN_CHUNK,
            drop_remainder=compat,
        ).total
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = pipeline.train_file(fa, params=params, num_iters=TRAIN_ITERS, convergence=0.0,
                                  compat=compat, engine=engine, backend=backend, device=dev)
        wall = time.perf_counter() - t0
        counts = {k: _kernels.launches[k] for k in kernels + absent}
        ll = res.logliks
        # EM never lowers the loglik; allow f32 rounding of a ~1e8 sum.
        monotone = all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))
        finite = all(bool(torch.isfinite(x).all()) for x in (
            res.params.log_pi, res.params.log_A, res.params.log_B))
        em_s = res.phases["em"]
        emit({
            "phase": "train", "model": model, "engine": engine, "mode": label,
            "symbols": symbols, "lanes": -(-symbols // chunking.TRAIN_CHUNK),
            "iterations": res.iterations, "wall_s": wall, "phases_s": res.phases,
            "em_msym_per_s": symbols * res.iterations / em_s / 1e6,
            "estep_ms_per_iter": res.phases["estep"] / res.iterations * 1e3,
            "mstep_ms_per_iter": res.phases["mstep"] / res.iterations * 1e3,
            "logliks": ll, "deltas": res.deltas, "launches": counts,
        })
        if (res.iterations != TRAIN_ITERS or any(counts[k] != TRAIN_ITERS for k in kernels)
                or any(counts[k] for k in absent)):
            raise SystemExit(f"chip_smoke: {model} {label} training launched {counts} in "
                             f"{res.iterations} iterations; want {TRAIN_ITERS} of each of "
                             f"{kernels} and none of {absent}")
        if not (monotone and finite):
            raise SystemExit(f"chip_smoke: {model} {label} training is not monotone or not finite")
        for k in kernels:
            launches[k] += counts[k]
        logliks[label] = ll
    return launches, logliks


# ---------------------------------------------------------------------------
# Phase 5: parity of the kernel paths with the plain paths


def path_score_f64(params, obs: np.ndarray, path: np.ndarray) -> float:
    lp = params.log_pi.double().cpu().numpy()
    lA = params.log_A.double().cpu().numpy()
    lB = params.log_B.double().cpu().numpy()
    o = obs.astype(np.int64)
    p = path.astype(np.int64)
    return float(lp[p[0]] + lB[p[0], o[0]] + lA[p[:-1], p[1:]].sum() + lB[p[1:], o[1:]].sum())


def small_fasta(rng: np.random.Generator, path: str) -> str:
    with open(path, "wb") as f:
        for i in range(3):
            f.write(to_fasta_bytes(rng, f"r{i}", make_sequence(rng, 40_000 + 7_000 * i)))
    return path


def probs(params) -> list:
    return [x.double().cpu().numpy() for x in (params.pi, params.A, params.B)]


def parity_phase(rng: np.random.Generator, params, big: np.ndarray, tmp: str, dev) -> None:
    obs = big[:PARITY_SYMBOLS]
    path_k = viterbi_sharded(params, obs, engine="onehot")
    kernels = (OH.oh_products, OH.oh_backpointers, OH.oh_backtrace)
    OH.oh_products, OH.oh_backpointers, OH.oh_backtrace = (
        OH.oh_products_plain, OH.oh_backpointers_plain, OH.oh_backtrace_plain)
    try:
        path_p = viterbi_sharded(params, obs, engine="onehot")
    finally:
        OH.oh_products, OH.oh_backpointers, OH.oh_backtrace = kernels
    same = bool(np.array_equal(path_k, path_p))
    sk, sp = path_score_f64(params, obs, path_k), path_score_f64(params, obs, path_p)
    emit({"phase": "path_parity", "symbols": int(obs.size), "paths_equal": same,
          "mismatches": int((path_k != path_p).sum()), "score_k": sk, "score_p": sp})
    if not same and sk != sp:
        raise SystemExit("chip_smoke: kernel path differs from the plain path")

    fa = small_fasta(rng, os.path.join(tmp, "small.fa"))
    files = {}
    for where in ("cpu", dev):
        buf = io.StringIO()
        pipeline.decode_file(fa, params, islands_out=buf, compat=False, device=where)
        files[str(where)] = buf.getvalue()
    same = files["cpu"] == files[str(dev)]
    emit({"phase": "cpu_vs_cuda_islands", "identical": same,
          "lines": files[str(dev)].count("\n")})
    if not same:
        raise SystemExit("chip_smoke: island files differ between CPU and CUDA")

    # EM through the kernels vs through their plain versions, on the card.
    chunked = chunking.frame(obs, chunking.TRAIN_CHUNK)
    fit_k = baum_welch.fit(params, chunked, num_iters=3, convergence=0.0)
    kernels = (FB.oh_fwdbwd, FB.oh_seq_stats)
    FB.oh_fwdbwd = FB.oh_fwdbwd_plain
    FB.oh_seq_stats = FB.oh_seq_stats_plain
    try:
        fit_p = baum_welch.fit(params, chunked, num_iters=3, convergence=0.0)
    finally:
        FB.oh_fwdbwd, FB.oh_seq_stats = kernels
    ll_ok = np.allclose(fit_k.logliks, fit_p.logliks, rtol=1e-5, atol=0)
    p_err = max(float(np.abs(a - b).max()) for a, b in zip(probs(fit_k.params), probs(fit_p.params)))
    emit({"phase": "train_parity", "symbols": int(obs.size), "iterations": fit_k.iterations,
          "logliks_kernel": fit_k.logliks, "logliks_plain": fit_p.logliks,
          "max_prob_err": p_err})
    if not (ll_ok and p_err <= 1e-5 and fit_k.iterations == fit_p.iterations):
        raise SystemExit("chip_smoke: EM through the kernels differs from the plain path")

    # The six-argument run of a small FASTA (clean mode: compat would train
    # and decode nothing this small) on the CPU and on the card.
    out = {}
    for where in ("cpu", dev):
        isl, mod = (os.path.join(tmp, f"run_small.{where}.{x}") for x in ("islands", "model"))
        pipeline.run(fa, fa, isl, mod, 0.005, 3, compat=False, device=where)
        with open(isl) as f:
            out[str(where)] = (f.read(), probs(load_text(mod)))
    (isl_c, p_c), (isl_g, p_g) = out["cpu"], out[str(dev)]
    d_err = max(float(np.abs(a - b).max()) for a, b in zip(p_c, p_g))
    zeros_same = all(np.array_equal(a == 0, b == 0) for a, b in zip(p_c, p_g))
    emit({"phase": "run_cpu_vs_cuda", "islands_identical": isl_c == isl_g,
          "lines": isl_g.count("\n"), "max_dump_err": d_err, "structural_zeros_same": zeros_same})
    if not (isl_c == isl_g and d_err <= 1e-5 and zeros_same):
        raise SystemExit("chip_smoke: run on the CPU and on the card disagree")


# ---------------------------------------------------------------------------
# Phase 6: the reference's six-argument run at its defaults


def run_phase(fa: str, tmp: str, dev) -> dict:
    isl, mod = os.path.join(tmp, "run.islands.txt"), os.path.join(tmp, "run.model.txt")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.run(fa, fa, isl, mod, 0.005, 10, compat=True, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    check_calls(res, "run")
    model = load_text(mod)
    finite = all(bool(torch.isfinite(x).all()) for x in (model.log_pi, model.log_A, model.log_B))
    emit({"phase": "run", "mode": "compat", "wall_s": wall, "symbols_decoded": res.n_symbols,
          "islands": len(res.calls), "launches": launches})
    missing = [k for k in DECODE_KERNELS + TRAIN_KERNELS if launches[k] == 0]
    if missing or not finite:
        raise SystemExit(f"chip_smoke: run never launched {missing} or wrote a non-finite model")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the posterior main path, and its parity


def posterior_phase(params, fa: str, tmp: str, dev, prod="oh_prod", chains=("oh_fwdbwd",),
                    absent=DENSE_FB_KERNELS, island_states=None, model="durbin8") -> dict:
    """posterior_file at the default span and at a 16 Mi span: the products
    kernel ``prod`` launches once per span pass and per transfer total,
    each of ``chains`` at least once, none of ``absent``.  Returns the
    launch counts of both runs together."""
    runs, launches = {}, {k: 0 for k in (prod,) + chains}
    for label, span, want_prod in POSTERIOR_RUNS:
        isl, conf = (os.path.join(tmp, f"posterior.{model}.{label}.{x}") for x in ("txt", "npy"))
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = pipeline.posterior_file(fa, params, islands_out=isl, confidence_out=conf,
                                      span=span, island_states=island_states, device=dev)
        wall = time.perf_counter() - t0
        counts = {k: _kernels.launches[k] for k in (prod,) + chains + tuple(absent)}
        check_calls(res, f"posterior {model} {label}")
        emit({
            "phase": "posterior", "model": model, "span": span, "symbols": res.n_symbols,
            "records": res.n_records, "islands": len(res.calls),
            "mean_island_confidence": res.mean_island_confidence, "wall_s": wall,
            "phases_s": res.phases, "msym_per_s": res.n_symbols / wall / 1e6,
            "posterior_msym_per_s": res.n_symbols / res.phases["posterior"] / 1e6,
            "launches": counts,
        })
        if (counts[prod] != want_prod or any(counts[k] == 0 for k in chains)
                or any(counts[k] for k in absent)):
            raise SystemExit(f"chip_smoke: {model} posterior ({label}) launched {counts}; "
                             f"{prod} must launch {want_prod} times, each of {chains} at "
                             f"least once, none of {absent}")
        for k in launches:
            launches[k] += counts[k]
        with open(isl) as f:
            runs[label] = (f.read(), np.load(conf), res.mean_island_confidence)
        if label == "default":
            device_islands_s = res.phases["islands"]
    (isl_a, conf_a, mean_a), (isl_b, conf_b, mean_b) = runs.values()
    same = isl_a == isl_b
    err = float(np.abs(conf_a.astype(np.float64) - conf_b).max())
    emit({"phase": "posterior_spans", "model": model, "islands_identical": same,
          "max_conf_err": err,
          "mean_conf_diff": abs(mean_a - mean_b)})
    if not (same and err <= 1e-4 and abs(mean_a - mean_b) <= 1e-6):
        raise SystemExit(f"chip_smoke: the {model} span-threaded posterior differs from the "
                         "one-pass")
    posterior_island_engines(params, fa, tmp, dev, island_states, model, isl_a, mean_a,
                             device_islands_s)
    return launches


def posterior_island_engines(params, fa: str, tmp: str, dev, island_states, model: str,
                             device_file: str, device_mean: float, device_islands_s: float):
    """The default-span posterior again with the host island engine (its
    island file must equal the device engine's), and an island-only run
    on the device engine (the confidence summed on the card: its mean
    within 1e-6 relative of the host-summed one)."""
    isl, conf = (os.path.join(tmp, f"posterior.{model}.host.{x}") for x in ("txt", "npy"))
    t0 = time.perf_counter()
    res = pipeline.posterior_file(fa, params, islands_out=isl, confidence_out=conf,
                                  island_states=island_states, island_engine="host", device=dev)
    wall = time.perf_counter() - t0
    with open(isl) as f:
        host_file = f.read()
    buf = io.StringIO()
    t0 = time.perf_counter()
    res_only = pipeline.posterior_file(fa, params, islands_out=buf, island_states=island_states,
                                       device=dev)
    wall_only = time.perf_counter() - t0
    same = host_file == device_file == buf.getvalue()
    rel = abs(res_only.mean_island_confidence - device_mean) / abs(device_mean)
    emit({"phase": "posterior_island_engines", "model": model, "identical": same,
          "lines": host_file.count("\n"), "device_islands_s": device_islands_s,
          "host_islands_s": res.phases["islands"], "host_wall_s": wall,
          "host_phases_s": res.phases, "island_only_wall_s": wall_only,
          "island_only_phases_s": res_only.phases, "island_only_mean_rel_diff": rel})
    if not (same and host_file and rel <= 1e-6 and res.mean_island_confidence == device_mean):
        raise SystemExit(f"chip_smoke: the {model} posterior's island engines disagree")


def posterior_fasta(rng: np.random.Generator, path: str) -> str:
    """Three records longer than a 32 Ki span and four scaffolds."""
    with open(path, "wb") as f:
        for i, n in enumerate((40_000, 47_000, 54_000, 3_000, 9_000, 1_500, 12_000)):
            f.write(to_fasta_bytes(rng, f"p{i}", make_sequence(rng, n)))
    return path


def posterior_parity_phase(rng: np.random.Generator, params, big: np.ndarray, tmp: str,
                           dev) -> None:
    obs = torch.from_numpy(big[:PARITY_SYMBOLS]).to(dev)
    mask = np.zeros(params.n_states, np.float32)
    mask[list(ISLAND_STATES)] = 1.0
    conf_k, path_k = fb_seq.seq_posterior(params, obs, obs.shape[0], mask, want_path=True)
    kernels = (FB.oh_prod, FB.oh_fwdbwd)
    FB.oh_prod, FB.oh_fwdbwd = FB.oh_prod_plain, FB.oh_fwdbwd_plain
    try:
        conf_p, path_p = fb_seq.seq_posterior(params, obs, obs.shape[0], mask, want_path=True)
    finally:
        FB.oh_prod, FB.oh_fwdbwd = kernels
    torch.cuda.synchronize()
    same = torch.equal(conf_k, conf_p) and torch.equal(path_k, path_p)
    emit({"phase": "posterior_parity", "symbols": int(obs.shape[0]), "bit_equal": same,
          "max_conf_err": max_abs_err(conf_k, conf_p),
          "path_mismatches": int((path_k != path_p).sum())})
    if not same:
        raise SystemExit("chip_smoke: the kernel posterior differs from the plain posterior")

    fa = posterior_fasta(rng, os.path.join(tmp, "posterior_small.fa"))
    out = {}
    for where in ("cpu", dev):
        buf = io.StringIO()
        conf = os.path.join(tmp, f"posterior_small.{where}.npy")
        pipeline.posterior_file(fa, params, islands_out=buf, confidence_out=conf,
                                span=1 << 15, device=where)
        out[str(where)] = (buf.getvalue(), np.load(conf))
    (isl_c, conf_c), (isl_g, conf_g) = out["cpu"], out[str(dev)]
    err = float(np.abs(conf_c.astype(np.float64) - conf_g).max())
    emit({"phase": "posterior_cpu_vs_cuda", "islands_identical": isl_c == isl_g,
          "lines": isl_g.count("\n"), "max_conf_err": err})
    if not (isl_c == isl_g and isl_g and err <= 1e-5):
        raise SystemExit("chip_smoke: posterior on the CPU and on the card disagree")


# ---------------------------------------------------------------------------
# Phase 8: where the device time goes


def device_rows(prof) -> list:
    """(name, device us, count) of device-side events only (kernels,
    copies): a host operator also carries its kernels' device time and
    would count it twice."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us, e.count))
    return sorted(rows, key=lambda r: -r[1])


def profiled(what: str, fn) -> dict:
    """torch.profiler over one call of ``fn`` (already warm): device time by
    kernel name, and the device's busy and idle share of the wall time
    (printed, and returned)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    line = {
        "phase": "profile", "what": what, "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall if rows else None,
        "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c} for k, us, c in rows[:14]],
    }
    emit(line)
    return line


def profile_phase(params, big: np.ndarray, fa: str, dev) -> None:
    viterbi_sharded(params, big[: 1 << 20], engine="onehot")  # warm caches
    profiled(f"viterbi_sharded, {big.size} symbols",
             lambda: viterbi_sharded(params, big, engine="onehot"))
    # The device island engine on that record's path, left on the card.
    path = viterbi_sharded(params, big, engine="onehot", return_device=True)
    call_islands_device(path[: 1 << 20])
    profiled(f"call_islands_device, {big.size} symbols", lambda: call_islands_device(path))
    del path

    profile_em(params, fa, dev, "durbin8")
    profile_posterior(params, big, ISLAND_STATES, "durbin8")


def profile_em(params, fa: str, dev, model: str) -> None:
    """One EM iteration of the compat training batch, as fit runs it: the
    E-step, the M-step and the one fetch of delta and loglik."""
    chunked = chunking.frame(codec.encode_file(fa), chunking.TRAIN_CHUNK,
                             drop_remainder=True)
    backend = LocalBackend()
    chunks, lengths = backend.place(chunked, dev)
    prep = backend.prepare_streams(params, chunks, lengths)

    def em_iteration():
        stats = backend(params, chunks, lengths, prepared=prep)
        _, delta = baum_welch.em_update(params, stats)
        return torch.stack([delta, stats.loglik]).tolist()

    em_iteration()
    profiled(f"one EM iteration {model} ({backend.resolved}), {chunked.num_chunks} chunks of "
             f"{chunking.TRAIN_CHUNK}", em_iteration)


def profile_posterior(params, big: np.ndarray, island_states, model: str) -> None:
    """One posterior of the big record (one span), MPM path included, to
    the host."""
    posterior_sharded(params, big[: 1 << 20], island_states, want_path=True)
    profiled(f"posterior_sharded {model}, {big.size} symbols",
             lambda: posterior_sharded(params, big, island_states, want_path=True))


# ---------------------------------------------------------------------------
# Phases 9-12: the dense Viterbi kernels (B13-B15) and the dense decode path


def dense_models(dev) -> dict:
    """K -> the model whose tables the dense kernels run at that K."""
    return {8: presets.durbin_cpg8(device=dev), 2: presets.two_state_cpg(device=dev)}


def dense_kernel_phase(rng: np.random.Generator, dev) -> dict:
    """B13-B15 at the decode geometry (64 Mi steps, PAD runs along the time
    axis) for K = 8 and K = 2; each bit-equal to its plain version.
    Returns the K = 8 rows (the flagship's dense route) by kernel name."""
    results = {}
    for K, params in dense_models(dev).items():
        S = params.n_symbols
        steps = rng.integers(0, S, size=(BK, NB)).astype(np.int32)
        for k0, b, n in zip(rng.integers(0, BK, size=NB // 4), rng.integers(0, NB, size=NB // 4),
                            rng.integers(1, 200, size=NB // 4)):
            steps[k0 : k0 + n, b] = S
        real = int((steps < S).sum())  # PAD steps are identity: no work
        steps_d = torch.from_numpy(steps).to(dev)
        v = rng.normal(scale=3.0, size=(K, NB)).astype(np.float32)
        v_d = torch.from_numpy(v - v.max(axis=0, keepdims=True)).to(dev)
        exits = torch.from_numpy(rng.integers(0, K, size=NB).astype(np.int32)).to(dev)
        logAT, logB = VP._tables(params)
        tab_b = (logAT.numel() + logB.numel()) * 4
        P_k = VP.dense_products(steps_d, logAT, logB)
        P_p, p_ms = timed_once(lambda: VP.dense_products_plain(steps_d, logAT, logB))
        bp_k = VP.dense_backpointers(steps_d, v_d, logAT, logB)
        bp_p, bp_ms = timed_once(lambda: VP.dense_backpointers_plain(steps_d, v_d, logAT, logB))
        path_k = VP.dense_backtrace(bp_k[0], exits, K)
        path_p, bt_ms = timed_once(lambda: VP.dense_backtrace_plain(bp_k[0], exits))
        steps_n = BK * NB
        rows = {  # (pairs to compare, kernel, plain ms, bytes moved, operations)
            "dense_products": (
                [(P_k, P_p)], lambda: VP.dense_products(steps_d, logAT, logB), p_ms,
                # steps read, [K*K, nb] written; K^3 adds + K^2 (K-1) maxes per real step
                4 * steps_n + tab_b + 4 * K * K * NB, K * K * (2 * K - 1) * real),
            "dense_backpointers": (
                list(zip(bp_k, bp_p)), lambda: VP.dense_backpointers(steps_d, v_d, logAT, logB),
                bp_ms,
                # steps read and packed pointers written; K^2 adds + K (K-1) compares
                8 * steps_n + tab_b + 8 * K * NB + 4 * NB, K * (2 * K - 1) * real),
            "dense_backtrace": (
                [(path_k, path_p)], lambda: VP.dense_backtrace(bp_k[0], exits, K), bt_ms,
                # packed pointers read, path written; shift and mask per step
                8 * steps_n + 4 * NB, 2 * steps_n),
        }
        for name, (pairs, kernel_fn, plain_ms, n_bytes, n_ops) in rows.items():
            equal = all(torch.equal(a, b) for a, b in pairs)
            err = max(max_abs_err(a, b) for a, b in pairs)
            row = kernel_row(name, equal, err, kernel_fn, plain_ms, n_bytes, n_ops, steps_n,
                             bit_equal=equal, K=K, real_steps=real)
            if not equal:
                raise SystemExit(f"chip_smoke: {name} (K={K}) disagrees with its plain version")
            if K == 8:
                results[name] = row
        del P_p, bp_p, path_p
    return results


def decode_to(fa: str, params, out: str, dev, **kw):
    """One clean decode with the launch counts of that run."""
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.decode_file(fa, params, islands_out=out, compat=False, device=dev, **kw)
    wall = time.perf_counter() - t0
    return res, wall, dict(_kernels.launches)


DENSE_RUNS = (  # label, preset, decode_file keywords
    ("mask", presets.durbin_cpg8, {"invalid_symbols": "mask"}),
    ("two_state", presets.two_state_cpg, {"island_states": (0,)}),
)


def dense_main_phase(fa: str, tmp: str, dev) -> dict:
    """The dense decode paths on the genome: launches of both runs
    together."""
    launches = {k: 0 for k in DENSE_KERNELS}
    for label, make, kw in DENSE_RUNS:
        res, wall, counts = decode_to(fa, make(device=dev), os.path.join(
            tmp, f"islands.{label}.device.txt"), dev, **kw)
        check_calls(res, label)
        emit({
            "phase": "dense_main_path", "mode": label, "symbols": res.n_symbols,
            "records": res.n_chunks, "islands": len(res.calls), "wall_s": wall,
            "phases_s": res.phases, "msym_per_s": res.n_symbols / wall / 1e6,
            "decode_msym_per_s": res.n_symbols / res.phases["decode"] / 1e6,
            "launches": counts,
        })
        dense_ok = all(counts[k] > 0 for k in DENSE_KERNELS)
        reduced = [counts[k] for k in DECODE_KERNELS]
        reduced_ok = all(reduced) if label == "mask" else not any(reduced)
        if not (dense_ok and reduced_ok and len(res.calls)):
            raise SystemExit(f"chip_smoke: the {label} decode launched {counts} and called "
                             f"{len(res.calls)} islands")
        for k in DENSE_KERNELS:
            launches[k] += counts[k]
    dense_flush_timings(fa, dev)
    return launches


def dense_flush_timings(fa: str, dev) -> None:
    """B13, B14 and B15 on the operands the largest of the two_state
    decode's scaffold flushes hands them (FLUSH_RECORDS records padded by
    ``pipeline._pad_small_batch``, decoded by ``pipeline._batch_paths``;
    32 of each one's 33 K = 2 launches in that run are such flushes): each
    held bit for bit against its plain version and timed (CUDA events,
    median of 10) through its wrapper and its C entry; one line with the
    shape."""
    two = presets.two_state_cpg(device=dev)
    recs = [(name, s) for name, s in codec.iter_fasta_records(fa) if name != "chr1"]
    flushes = [recs[i : i + FLUSH_RECORDS] for i in range(0, len(recs), FLUSH_RECORDS)]
    rows, lengths = pipeline._pad_small_batch(
        max(flushes, key=lambda b: pipeline._pad_small_batch(b)[0].size))
    ops = {name: _captured(lambda: pipeline._batch_paths(
        two, resolve_engine("auto", two), rows, lengths), VP, name)[1] for name in DENSE_KERNELS}
    steps, logAT, logB = ops["dense_products"][0]
    bk, nb = steps.shape
    plains = {"dense_products": VP.dense_products_plain,
              "dense_backpointers": VP.dense_backpointers_plain,
              "dense_backtrace": lambda bp, exits, K: VP.dense_backtrace_plain(bp, exits)}
    ints = {"dense_products": {"K": 2, "S": logB.shape[1]},
            "dense_backpointers": {"K": 2, "S": logB.shape[1]},
            "dense_backtrace": {"K": 2, "seg": 0}}
    line = {"phase": "dense_flush_geometry", "padded": list(rows.shape), "bk": bk, "nb": nb,
            "K": 2, "bit_equal": {}, "ms": {}, "direct_ms": {}, "plain_ms": {}}
    for name, (args, got) in ops.items():
        got = got if isinstance(got, tuple) else (got,)
        want, line["plain_ms"][name] = timed_once(lambda: plains[name](*args))
        want = want if isinstance(want, tuple) else (want,)
        line["bit_equal"][name] = all(torch.equal(a, b) for a, b in zip(got, want))
        line["ms"][name] = time_ms(lambda: getattr(VP, name)(*args), runs=10)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        line["direct_ms"][name] = direct_ms(name, [*tensors, *got], bk=bk, nb=nb, **ints[name])
    emit(line)
    if not all(line["bit_equal"].values()):
        raise SystemExit(f"chip_smoke: the dense decode kernels at the two_state flush's "
                         f"geometry disagree with their plain versions: {line['bit_equal']}")


def island_engine_phase(fa: str, tmp: str, dev) -> None:
    """Each clean decode again with the host island engine: files identical
    to the device engine's."""
    runs = (("clean", presets.durbin_cpg8, {}),) + DENSE_RUNS
    for label, make, kw in runs:
        res, wall, _ = decode_to(fa, make(device=dev), os.path.join(
            tmp, f"islands.{label}.host.txt"), dev, island_engine="host", **kw)
        with open(os.path.join(tmp, f"islands.{label}.host.txt")) as f:
            host = f.read()
        with open(os.path.join(tmp, f"islands.{label}.device.txt")) as f:
            device = f.read()
        emit({"phase": "island_engines", "mode": label, "identical": host == device,
              "lines": host.count("\n"), "host_islands_s": res.phases["islands"],
              "host_decode_s": res.phases["decode"], "host_wall_s": wall})
        if host != device or not host:
            raise SystemExit(f"chip_smoke: {label} island files differ between engines")


def dense_parity_phase(rng: np.random.Generator, big: np.ndarray, tmp: str, dev) -> None:
    """The first 4 Mi symbols of the big record, N-led, through the dense
    kernels and through their plain versions on the card; then a small
    N-led FASTA decoded on the CPU and on the card."""
    obs = np.concatenate([np.full(BIG_LEAD_N, 4, np.uint8), big[: PARITY_SYMBOLS - BIG_LEAD_N]])
    for K, params in dense_models(dev).items():
        path_k = viterbi_sharded(params, obs, engine="pallas")
        kernels = (VP.dense_products, VP.dense_backpointers, VP.dense_backtrace)
        VP.dense_products, VP.dense_backpointers, VP.dense_backtrace = (
            VP.dense_products_plain, VP.dense_backpointers_plain,
            lambda bp, exits, K: VP.dense_backtrace_plain(bp, exits))
        try:
            path_p = viterbi_sharded(params, obs, engine="pallas")
        finally:
            VP.dense_products, VP.dense_backpointers, VP.dense_backtrace = kernels
        same = bool(np.array_equal(path_k, path_p))
        emit({"phase": "dense_path_parity", "K": K, "symbols": int(obs.size),
              "paths_equal": same, "mismatches": int((path_k != path_p).sum())})
        if not same:
            raise SystemExit(f"chip_smoke: the dense kernel path (K={K}) differs from the plain path")

    fa = os.path.join(tmp, "dense_small.fa")
    with open(fa, "wb") as f:
        for i, n in enumerate((40_000, 3_000, 9_000, 20_000)):
            f.write(to_fasta_bytes(rng, f"d{i}", make_sequence(rng, n), lead_n=500 * (i % 2)))
    for label, make, kw in DENSE_RUNS:
        out = {}
        for where in ("cpu", dev):
            buf = io.StringIO()
            pipeline.decode_file(fa, make(), islands_out=buf, compat=False, device=where, **kw)
            out[str(where)] = buf.getvalue()
        same = out["cpu"] == out[str(dev)]
        emit({"phase": "dense_cpu_vs_cuda", "mode": label, "identical": same,
              "lines": out[str(dev)].count("\n")})
        if not (same and out["cpu"]):
            raise SystemExit(f"chip_smoke: {label} island files differ between CPU and CUDA")


def dense_profile_phase(big: np.ndarray, dev) -> None:
    obs = np.concatenate([np.full(BIG_LEAD_N, 4, np.uint8), big])
    for K, params in dense_models(dev).items():
        viterbi_sharded(params, obs[: 1 << 20], engine="pallas")  # warm caches
        profiled(f"viterbi_sharded pallas K={K}, {obs.size} symbols",
                 lambda: viterbi_sharded(params, obs, engine="pallas"))


# ---------------------------------------------------------------------------
# Phases 13-16: the dense forward-backward kernels (B16-B20) and the dense
# train and posterior paths


def _agree_row(name, got, want, kernel_fn, plain_ms, n_bytes, n_ops, steps, K, tol=None,
               **extra) -> dict:
    """Hold a dense FB kernel's outputs against its plain version's (bit
    for bit, or within ``tol`` = (rtol, atol)), time it and print its row;
    raise on a disagreement."""
    if tol is None:
        agree = all(torch.equal(g, w) for g, w in zip(got, want))
        extra["bit_equal"] = agree
    else:
        agree = all(torch.allclose(g, w, rtol=tol[0], atol=tol[1]) for g, w in zip(got, want))
        extra["tolerance"] = f"rtol {tol[0]:g}, atol {tol[1]:g}"
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    row = kernel_row(name, agree, err, kernel_fn, plain_ms, n_bytes, n_ops, steps, K=K,
                     **extra)
    if not agree:
        raise SystemExit(f"chip_smoke: {name} (K={K}, {extra.get('geometry')}) disagrees with "
                         "its plain version")
    return row


def chain_kernel(name: str, K: int, G: int) -> str:
    """The CUDA kernels B16 (``fb_fwd``), B18 (``fb_bwd``) or B19
    (``fb_bwd_conf``) run at K and G (csrc/fb_dense.cu)."""
    if name == "fb_bwd_conf":
        if K > FP.BWD_SUBLANE_MAX_K:
            return f"fb_bwd_split_conf_kernel<{K}>"
        if G > 1:
            return f"fb_bwd_sub_kernel<{K}, true>, fb_bwd_sub_conf_kernel<{K}>"
        return f"fb_bwd_kernel<{K}, true>"
    stem = name + "_"
    if K > FP.BWD_SUBLANE_MAX_K:
        return f"{stem}split_kernel<{K}>"
    if G > 1:
        return f"{stem}sub_kernel<{K}, " + ("0 / 1 / 2>" if name == "fb_fwd" else "true / false>")
    return f"{stem}kernel<{K}" + (">" if name == "fb_fwd" else ", false>")


def random_dense_model(K: int, S: int, dev) -> HmmParams:
    """A seeded random K-state model over S symbols (its own generator)."""
    own = np.random.default_rng(100 + K)
    return HmmParams.from_probs(own.dirichlet(np.ones(K)), own.dirichlet(np.ones(K), size=K),
                                own.dirichlet(np.ones(S), size=K), device=dev)


def dense_fb_kernel_phase(rng: np.random.Generator, dev) -> dict:
    """B16, B18 and B20 at the training geometry (FB_NL ragged chunks of
    FB_TP steps) and B17, B16 and B19 at the posterior's (one 64 Mi span
    as POST_NL lanes of POST_LANE_T steps, a PAD tail), for K = 8 (the
    flagship's tables), K = 2 (two_state) and K = 5 (a random model over
    4 symbols, B16 and B18 only: the state-split chains at their smallest
    K; its draws from a generator of its own, so ``rng`` reaches the later
    phases unchanged).  B16-B19 bit-equal to their plain versions, B20
    within rtol 1e-5 / atol 1e-3.  Returns the rows for the table by kernel
    name: K = 8, B17 and B19 at the posterior geometry, the others at the
    training one."""
    results = {}
    # (K, model, the generator of its draws)
    models = [(K, params, rng) for K, params in dense_models(dev).items()]
    models.append((5, random_dense_model(5, 4, dev), np.random.default_rng(5)))
    for K, params, gen in models:
        S = params.n_symbols
        chains_only = K == 5
        A, B, _ = FP.tables(params)
        tab_b = (A.numel() + B.numel()) * 4
        keep = {}

        chunks, lengths = ragged_chunks(gen, S)
        prep = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                               torch.from_numpy(lengths).to(dev),
                               t_tile=fb_chunked.DEFAULT_T_TILE, onehot=False)
        _, a0, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
        Tp, NL = prep.steps2.shape
        n, valid = Tp * NL, int(np.minimum(lengths, Tp).sum())
        geo = {"geometry": "train", "valid_steps": valid}
        args = (prep.steps2, prep.lens2, a0, A, B)
        al = FP.fb_fwd(*args)
        al_p, plain_ms = timed_once(lambda: FP.fb_fwd_plain(*args))
        sweep = fwd_sweep(args, K)
        keep["fb_fwd"] = _agree_row(
            "fb_fwd", [al], [al_p], lambda: FP.fb_fwd(*args), plain_ms,
            # steps read, alphas written; K^2 products, K(K-1) sums, 2K scalings,
            # the row sum and its reciprocal a valid step
            4 * n + 4 * K * n + 4 * NL + 4 * K * NL + tab_b, (2 * K * K + 2 * K) * valid, n,
            K, sublanes=FP.fwd_sublanes(Tp, K),
            cuda_kernel=chain_kernel("fb_fwd", K, FP.fwd_sublanes(Tp, K)), **sweep, **geo)
        del al_p
        if sweep and not sweep["g1_bit_equal"]:
            raise SystemExit(f"chip_smoke: fb_fwd (K={K}) in one sub-lane disagrees with its "
                             "plain version")
        _, steps_next, cs_next = FP.backward_inputs(prep.steps2, al)
        args = (steps_next, prep.lens2, cs_next, beta0, A, B, FB_TP)
        be = FP.fb_bwd(*args)
        be_p, plain_ms = timed_once(lambda: FP.fb_bwd_plain(*args))
        sweep = bwd_sweep(args, K)
        keep["fb_bwd"] = _agree_row(
            "fb_bwd", [be], [be_p], lambda: FP.fb_bwd(*args), plain_ms,
            # o_{t+1} and c_{t+1} read, betas written
            8 * n + 4 * K * n + 4 * NL + 4 * K * NL + tab_b, (2 * K * K + K + 1) * valid, n,
            K, sublanes=FP.bwd_sublanes(Tp, K),
            cuda_kernel=chain_kernel("fb_bwd", K, FP.bwd_sublanes(Tp, K)), **sweep, **geo)
        del be_p
        if sweep and not sweep["g1_bit_equal"]:
            raise SystemExit(f"chip_smoke: fb_bwd (K={K}) in one sub-lane disagrees with its "
                             "plain version")
        if chains_only:
            del al, be, prep, steps_next, cs_next
        else:
            args = (al, be, prep.steps2, prep.lens2, B)
            got = FP.fb_stats(*args, prep.Tt)
            want, plain_ms = timed_once(lambda: FP.fb_stats_plain(*args))
            keep["fb_stats"] = _agree_row(
                "fb_stats", list(got), list(want), lambda: FP.fb_stats(*args, prep.Tt), plain_ms,
                # alphas, betas and the symbol read at the valid steps, the counts written
                (8 * K + 4) * valid + 4 * NL + 4 * B.numel() + 4 * (K * K + K * S + 1) * NL,
                (2 * K * K + 7 * K + 3) * valid, valid, K, tol=(1e-5, 1e-3), **geo)
            del al, be, got, want, prep, steps_next, cs_next

        T = POST_NL * POST_LANE_T
        obs = torch.from_numpy(gen.integers(0, S, size=T).astype(np.uint8)).to(dev)
        prep = prepare_seq(S, obs, T - POST_LANE_T // 3, lane_T=POST_LANE_T, onehot=False)
        Tp, NL = prep.steps2.shape
        assert (Tp, NL) == (POST_LANE_T, POST_NL)
        n, real = Tp * NL, int((prep.sel2 < S).sum())
        geo = {"geometry": "posterior span", "valid_steps": real}
        if not chains_only:
            tab = FP.step_table(A, B)
            P = FP.fb_prod(prep.sel2, tab)
            P_p, plain_ms = timed_once(lambda: FP.fb_prod_plain(prep.sel2, tab))
            keep["fb_prod"] = _agree_row(
                "fb_prod", [P], [P_p], lambda: FP.fb_prod(prep.sel2, tab), plain_ms,
                # the step stream read, the K x K products written; K^2 (2K - 1) a
                # real step, and a renormalization every 8 steps
                4 * n + 4 * tab.numel() + 4 * K * K * NL,
                K * K * (2 * K - 1) * real + 2 * K * K * (n // 8), n, K, **geo)
            del P, P_p
        lens2 = prep.lane_lens[None, :].contiguous()
        rand = lambda: torch.from_numpy(  # noqa: E731
            gen.random((K, NL)).astype(np.float32) + 0.01).to(dev)
        args = (prep.steps2, lens2, rand(), A, B)
        al = FP.fb_fwd(*args)
        al_p, plain_ms = timed_once(lambda: FP.fb_fwd_plain(*args))
        sweep = fwd_sweep(args, K)
        _agree_row("fb_fwd", [al], [al_p], lambda: FP.fb_fwd(*args), plain_ms,
                   4 * n + 4 * K * n + 4 * NL + 4 * K * NL + tab_b,
                   (2 * K * K + 2 * K) * real, n, K, sublanes=FP.fwd_sublanes(Tp, K),
                   cuda_kernel=chain_kernel("fb_fwd", K, FP.fwd_sublanes(Tp, K)), **sweep, **geo)
        del al_p
        if sweep and not sweep["g1_bit_equal"]:
            raise SystemExit(f"chip_smoke: fb_fwd (K={K}, posterior span) in one sub-lane "
                             "disagrees with its plain version")
        _, steps_next, cs_next = FP.backward_inputs(prep.steps2, al)
        # B18 on the posterior lanes (G = 8 at K <= 4; the sweep times G = 1,
        # 2, 4 and 32 too).  Its entering betas come from a generator of their
        # own, so the draws reach the later phases (the genome) unchanged.
        own = np.random.default_rng(K)
        beta0 = torch.from_numpy(own.random((K, NL)).astype(np.float32) + 0.01).to(dev)
        args = (steps_next, lens2, cs_next, beta0, A, B, POST_LANE_T)
        be = FP.fb_bwd(*args)
        be_p, plain_ms = timed_once(lambda: FP.fb_bwd_plain(*args))
        sweep = bwd_sweep(args, K)
        _agree_row("fb_bwd", [be], [be_p], lambda: FP.fb_bwd(*args), plain_ms,
                   8 * n + 4 * K * n + 4 * NL + 4 * K * NL + tab_b,
                   (2 * K * K + K + 1) * real, n, K, sublanes=FP.bwd_sublanes(Tp, K),
                   cuda_kernel=chain_kernel("fb_bwd", K, FP.bwd_sublanes(Tp, K)), **sweep, **geo)
        del be, be_p, beta0
        if sweep and not sweep["g1_bit_equal"]:
            raise SystemExit(f"chip_smoke: fb_bwd (K={K}, posterior span) in one sub-lane "
                             "disagrees with its plain version")
        if chains_only:
            del al, prep, obs
            continue
        mask = torch.tensor([1.0] * (K // 2) + [0.0] * (K - K // 2), device=dev)
        args = (steps_next, lens2, cs_next, rand(), al, mask, A, B, POST_LANE_T)
        conf = FP.fb_bwd_conf(*args)
        conf_p, plain_ms = timed_once(lambda: FP.fb_bwd_conf_plain(*args))
        G = FP.bwd_sublanes(Tp, K)
        keep["fb_bwd_conf"] = _agree_row(
            "fb_bwd_conf", [conf], [conf_p], lambda: FP.fb_bwd_conf(*args), plain_ms,
            # o_{t+1}, c_{t+1} and the alphas read, the confidence written
            8 * n + 4 * K * n + 4 * n + 4 * NL + 4 * K * NL + tab_b,
            (2 * K * K + 5 * K + 2) * real, n, K, sublanes=G,
            cuda_kernel=chain_kernel("fb_bwd_conf", K, G), **geo)
        del al, conf, conf_p, prep, obs
        if K == 8:
            results = keep
    return results


def dense_train_phase(params, fa: str, dev, onehot_logliks: dict) -> dict:
    """two_state training, compat then clean (B16, B18 and B20 once per EM
    iteration, B4 and B5 never); then the flagship through the dense
    engine, clean, whose loglik trajectory must match the reduced
    engine's (``onehot_logliks``, phase 4) within rtol 1e-5.  Returns the
    two_state runs' launch counts."""
    launches, _ = train_phase(presets.two_state_cpg(device=dev), fa, dev, DENSE_TRAIN_KERNELS,
                              TRAIN_KERNELS, model="two_state")
    _, ll = train_phase(params, fa, dev, DENSE_TRAIN_KERNELS, TRAIN_KERNELS, engine="pallas",
                        modes=(("clean", False),))
    a, b = np.asarray(ll["clean"]), np.asarray(onehot_logliks["clean"])
    emit({"phase": "train_engines", "model": "durbin8", "mode": "clean",
          "logliks_pallas": ll["clean"], "logliks_onehot": onehot_logliks["clean"],
          "max_rel_diff": float(np.max(np.abs(a - b) / np.abs(b)))})
    if not np.allclose(a, b, rtol=1e-5, atol=0):
        raise SystemExit("chip_smoke: the flagship trains differently through the dense engine")
    return launches


def dense_posterior_phase(fa: str, tmp: str, dev) -> dict:
    """two_state posterior with island_states=(0,) at the default span
    (B17 once, for the big record) and at a 16 Mi span (B17 8 times), B16
    and B18 in both; then a confidence-only run at the default span
    (B19, never B18) whose confidence must equal the path run's within
    1e-6.  Returns the launch counts of the three runs."""
    two = presets.two_state_cpg(device=dev)
    launches = posterior_phase(two, fa, tmp, dev, prod="fb_prod", chains=("fb_fwd", "fb_bwd"),
                               absent=POSTERIOR_KERNELS + ("fb_bwd_conf",),
                               island_states=(0,), model="two_state")
    conf = os.path.join(tmp, "posterior.two_state.conf_only.npy")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.posterior_file(fa, two, confidence_out=conf, island_states=(0,), device=dev)
    wall = time.perf_counter() - t0
    counts = {k: _kernels.launches[k] for k in DENSE_FB_KERNELS}
    err = float(np.abs(np.load(conf).astype(np.float64)
                       - np.load(os.path.join(tmp, "posterior.two_state.default.npy"))).max())
    emit({"phase": "posterior", "model": "two_state", "output": "confidence only",
          "symbols": res.n_symbols, "wall_s": wall, "phases_s": res.phases,
          "msym_per_s": res.n_symbols / wall / 1e6,
          "posterior_msym_per_s": res.n_symbols / res.phases["posterior"] / 1e6,
          "launches": counts, "max_conf_err_vs_path_run": err})
    if counts["fb_bwd_conf"] == 0 or counts["fb_bwd"] or counts["fb_prod"] != 1 or err > 1e-6:
        raise SystemExit(f"chip_smoke: the confidence-only posterior launched {counts} "
                         f"(max confidence error {err} vs the path run)")
    for k in ("fb_bwd_conf", "fb_fwd", "fb_prod"):
        launches[k] = launches.get(k, 0) + counts[k]
    return launches


def _swap_plain(use_plain: bool, fn):
    """``fn()`` with the dense FB kernel wrappers replaced by their plain
    versions (on the card) when ``use_plain``."""
    kernels = {k: getattr(FP, k) for k in DENSE_FB_KERNELS}
    if use_plain:
        FP.fb_fwd, FP.fb_bwd, FP.fb_prod = FP.fb_fwd_plain, FP.fb_bwd_plain, FP.fb_prod_plain
        FP.fb_bwd_conf = FP.fb_bwd_conf_plain
        FP.fb_stats = lambda *args: FP.fb_stats_plain(*args[:-1])  # drops Tt
    try:
        return fn()
    finally:
        for k, f in kernels.items():
            setattr(FP, k, f)


def dense_fb_parity_phase(rng: np.random.Generator, big: np.ndarray, tmp: str, dev) -> None:
    """two_state on the first 4 Mi symbols of the big record through the
    dense kernels and through their plain versions on the card: the
    posterior (with and without the path) bit for bit, and a 3-iteration
    fit within rtol 1e-5 / atol 1e-5; then a small FASTA soft-decoded and
    trained on the CPU and on the card."""
    two = presets.two_state_cpg(device=dev)
    obs = torch.from_numpy(big[:PARITY_SYMBOLS]).to(dev)
    mask = np.array([1.0, 0.0], np.float32)
    for want_path in (True, False):
        def post():
            return fb_seq.seq_posterior(two, obs, obs.shape[0], mask, want_path=want_path,
                                        engine="pallas")

        conf_k, path_k = _swap_plain(False, post)
        conf_p, path_p = _swap_plain(True, post)
        torch.cuda.synchronize()
        same = torch.equal(conf_k, conf_p) and torch.equal(path_k, path_p)
        emit({"phase": "dense_posterior_parity", "model": "two_state", "want_path": want_path,
              "symbols": int(obs.shape[0]), "bit_equal": same,
              "max_conf_err": max_abs_err(conf_k, conf_p),
              "path_mismatches": int((path_k != path_p).sum())})
        if not same:
            raise SystemExit("chip_smoke: the dense kernel posterior differs from the plain one")

    chunked = chunking.frame(big[:PARITY_SYMBOLS], chunking.TRAIN_CHUNK)
    fits = [_swap_plain(p, lambda: baum_welch.fit(two, chunked, num_iters=3, convergence=0.0))
            for p in (False, True)]
    ll_ok = np.allclose(fits[0].logliks, fits[1].logliks, rtol=1e-5, atol=0)
    p_err = max(float(np.abs(a - b).max())
                for a, b in zip(probs(fits[0].params), probs(fits[1].params)))
    emit({"phase": "dense_train_parity", "model": "two_state", "symbols": PARITY_SYMBOLS,
          "logliks_kernel": fits[0].logliks, "logliks_plain": fits[1].logliks,
          "max_prob_err": p_err})
    if not (ll_ok and p_err <= 1e-5):
        raise SystemExit("chip_smoke: dense EM through the kernels differs from the plain path")

    fa = posterior_fasta(rng, os.path.join(tmp, "dense_posterior_small.fa"))
    out = {}
    for where in ("cpu", dev):
        buf = io.StringIO()
        conf = os.path.join(tmp, f"dense_posterior_small.{where}.npy")
        mod = os.path.join(tmp, f"dense_train_small.{where}.txt")
        pipeline.posterior_file(fa, presets.two_state_cpg(), islands_out=buf, confidence_out=conf,
                                island_states=(0,), span=1 << 15, device=where)
        pipeline.train_file(fa, params=presets.two_state_cpg(), compat=False, num_iters=3,
                            chunk_size=1 << 13, model_out=mod, device=where)
        out[str(where)] = (buf.getvalue(), np.load(conf), probs(load_text(mod)))
    (isl_c, conf_c, p_c), (isl_g, conf_g, p_g) = out["cpu"], out[str(dev)]
    c_err = float(np.abs(conf_c.astype(np.float64) - conf_g).max())
    d_err = max(float(np.abs(a - b).max()) for a, b in zip(p_c, p_g))
    zeros_same = all(np.array_equal(a == 0, b == 0) for a, b in zip(p_c, p_g))
    emit({"phase": "dense_cpu_vs_cuda", "mode": "two_state posterior and train",
          "islands_identical": isl_c == isl_g, "lines": isl_g.count("\n"), "max_conf_err": c_err,
          "max_dump_err": d_err, "structural_zeros_same": zeros_same})
    if not (isl_c == isl_g and isl_g and c_err <= 1e-5 and d_err <= 1e-5 and zeros_same):
        raise SystemExit("chip_smoke: the two_state posterior or training differs between the "
                         "CPU and the card")


def dense_fb_profile_phase(big: np.ndarray, fa: str, dev) -> None:
    two = presets.two_state_cpg(device=dev)
    profile_em(two, fa, dev, "two_state")
    profile_posterior(two, big, (0,), "two_state")


# ---------------------------------------------------------------------------
# Phases 17-20: the stacked kernels (B21, B24, B25), the scoring kernels, the
# compare main path and the family trainer


def family_members(gen: torch.Generator, dev, S: int, M: int) -> list:
    """The flagship (S = 4) or dinuc_cpg (S = 16) plus M - 1 random
    partition=2 members of its alphabet: a stacked member set."""
    first = presets.durbin_cpg8(device=dev) if S == 4 else presets.dinuc_cpg(device=dev)
    return [first] + [presets.random_hmm(gen, 2 * S, S, partition=2, device=dev)
                      for _ in range(M - 1)]


def chaining_stream(rng: np.random.Generator, n: int, S: int) -> np.ndarray:
    """n random symbols of the S-symbol alphabet; for S = 16 the pair recode
    of random bases, so consecutive pairs chain as dinuc_cpg requires."""
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    return base if S == 4 else codec.recode_pairs(base)


def chaining_chunks(rng: np.random.Generator, S: int):
    """ragged_chunks of the S-symbol alphabet, pair-recoded for S = 16."""
    chunks, lengths = ragged_chunks(rng, 4)
    if S == 16:
        pad = chunks == 4
        chunks = codec.recode_pairs(np.minimum(chunks, 3).ravel()).reshape(chunks.shape)
        chunks[pad] = 16
    return chunks, lengths


def _stacked_row(name, S, M, geometry, got, want, per_member, kernel_fn, plain_ms, single_ms,
                 n_bytes, n_ops, steps, tol=None, **more) -> dict:
    """Hold a stacked kernel against its plain version (bit for bit, or
    within ``tol``; ``want`` None where the plain version runs at another M
    only) and, per member, against the single-model kernel (bit for bit);
    time it beside M x the single-model kernel's time."""
    if want is None:
        row = kernel_row(name, per_member, None, kernel_fn, None, n_bytes, n_ops, steps, S=S,
                         M=M, geometry=geometry, equals_single_per_member=per_member,
                         single_ms=single_ms, m_times_single_ms=M * single_ms,
                         plain="run at M = 2 only; held per member against the single "
                               "kernel", **more)
        if not per_member:
            raise SystemExit(f"chip_smoke: {name} (S={S}, M={M}, {geometry}) disagrees with "
                             f"the single-model kernel per member")
        return row
    if tol is None:
        agree = all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        agree = all(torch.allclose(g, w, rtol=tol[0], atol=tol[1]) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    extra = {"bit_equal": agree} if tol is None else {"tolerance": f"rtol {tol[0]:g}, atol {tol[1]:g}"}
    row = kernel_row(name, agree and per_member, err, kernel_fn, plain_ms, n_bytes, n_ops,
                     steps, S=S, M=M, geometry=geometry,
                     equals_single_per_member=per_member, single_ms=single_ms,
                     m_times_single_ms=M * single_ms, **extra, **more)
    if not (agree and per_member):
        raise SystemExit(f"chip_smoke: {name} (S={S}, M={M}, {geometry}) disagrees with its plain "
                         f"version ({agree}) or with the single-model kernel per member "
                         f"({per_member})")
    return row


def stacked_kernel_phase(rng: np.random.Generator, gen: torch.Generator, dev) -> dict:
    """B21 at NL=8192 x lane_T=8192, B24 there and at NL=1024 x Tp=65,536,
    B25 at the training geometry, for each of STACK_CONFIGS: per member
    bit-equal to B7 / B4 / B5 (each held to its plain version in phase 2),
    and at M = 2 B21 and B24 bit-equal to their plain versions, B25 within
    rtol 1e-5 / atol 1e-3 of its plain version.  Returns the table rows (S
    = 4, M = 2) by kernel name."""
    results = {}
    T = POST_NL * POST_LANE_T
    for S in (4, 16):
        obs = torch.from_numpy(chaining_stream(rng, T, S)).to(dev)
        post = prepare_seq(S, obs, T - POST_LANE_T // 3, lane_T=POST_LANE_T)
        post_lens = post.lane_lens[None, :].contiguous()
        chunks, lengths = chaining_chunks(rng, S)
        train = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                                torch.from_numpy(lengths).to(dev),
                                t_tile=fb_chunked.DEFAULT_T_TILE)
        del obs
        for S_, M in STACK_CONFIGS:
            if S_ != S:
                continue
            members = family_members(gen, dev, S, M)
            gts, tabs = FB.stacked_tables(members)
            K = 2 * S
            plain = M in PLAIN_STACK_M
            tab_b = tabs[0].numel() * 4
            one = lambda m: tabs[m].contiguous()  # noqa: E731

            # B21 at the posterior geometry.
            Tp, NL = post.pair2.shape
            n = Tp * NL
            red = FB.oh_prod_stacked(post.pair2, tabs)
            red_p, plain_ms = plain_once(
                plain, lambda: [FB.oh_prod_stacked_plain(post.pair2, tabs)])
            per = all(torch.equal(FB.oh_prod(post.pair2, one(m)), red[m]) for m in range(M))
            single_ms = time_ms(lambda: FB.oh_prod(post.pair2, one(0)), runs=10)
            # In one sub-lane (G = 1) too: per member equal to B7 at G = 1.
            with prod_sublane_length(Tp):
                red1 = FB.oh_prod_stacked(post.pair2, tabs)
                per1 = all(torch.equal(FB.oh_prod(post.pair2, one(m)), red1[m])
                           for m in range(M))
                g1_ms = time_ms(lambda: FB.oh_prod_stacked(post.pair2, tabs), runs=10)
            row = _stacked_row(
                "oh_prod_stacked", S, M, "posterior span", [red], red_p, per and per1,
                lambda: FB.oh_prod_stacked(post.pair2, tabs), plain_ms, single_ms,
                # the shared pair stream read once, M tables, M x [4, NL] written
                4 * n + M * (tab_b + 16 * NL), M * 13 * n, n, sublanes=FB.prod_sublanes(Tp),
                g1_equals_single_per_member=per1, g1_ms=g1_ms)
            del red, red_p, red1

            # B24 at the posterior geometry, then at the training one.
            for geo, prep, lens2, steps_T in (("posterior span", post, post_lens, POST_LANE_T),
                                              ("train", train, train.lens2, FB_TP)):
                Tp, NL = prep.pair2.shape
                n = Tp * NL
                rand = lambda: torch.from_numpy(  # noqa: E731
                    rng.random((M, 2, NL)).astype(np.float32) + 0.01).to(dev)
                args = (prep.pair2, prep.pairn2, lens2, rand(), rand(), tabs, steps_T)
                al, be = FB.oh_fwdbwd_stacked(*args)
                want, plain_ms = plain_once(
                    plain, lambda: list(FB.oh_fwdbwd_stacked_plain(*args)))
                per = True
                for m in range(M):
                    a1, b1 = FB.oh_fwdbwd(prep.pair2, prep.pairn2, lens2, args[3][m], args[4][m],
                                          one(m), steps_T)
                    per = per and torch.equal(a1, al[m]) and torch.equal(b1, be[m])
                    del a1, b1
                single_ms = time_ms(lambda: FB.oh_fwdbwd(prep.pair2, prep.pairn2, lens2,
                                                         args[3][0], args[4][0], one(0), steps_T),
                                    runs=10)
                # In one sub-lane (G = 1) too: per member equal to B4 at G = 1.
                with sublane_length(Tp):
                    al1, be1 = FB.oh_fwdbwd_stacked(*args)
                    per1 = True
                    for m in range(M):
                        a1, b1 = FB.oh_fwdbwd(prep.pair2, prep.pairn2, lens2, args[3][m],
                                              args[4][m], one(m), steps_T)
                        per1 = per1 and torch.equal(a1, al1[m]) and torch.equal(b1, be1[m])
                        del a1, b1
                    del al1, be1
                    g1_ms = time_ms(lambda: FB.oh_fwdbwd_stacked(*args), runs=10)
                fwd_row = _stacked_row(
                    "oh_fwdbwd_stacked", S, M, geo, [al, be], want, per and per1,
                    lambda: FB.oh_fwdbwd_stacked(*args), plain_ms, single_ms,
                    # pair + pairn read once, M x (alphas + betas) written
                    8 * n + M * (16 * n + 16 * NL + tab_b) + 4 * NL, M * 2 * 7 * n, n,
                    sublanes=FB.sublanes(Tp), g1_equals_single_per_member=per1, g1_ms=g1_ms)
                del want
                if geo == "posterior span":
                    del al, be
            # B25 on the training geometry's streams, with the chunked
            # caller's zero enters and pair0 mask.
            Tp, NL = train.pair2.shape
            B_reds = torch.stack([FB.reduced_emissions(p, gt) for p, gt in zip(members, gts)])
            gts32 = gts.to(torch.int32).contiguous()
            zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
            st_args = (al, be, train.pair2, train.lens2, tabs, B_reds, gts32, zeros(M, K, NL),
                       zeros(M, 2, NL), zeros(1, NL))
            got = FB.oh_seq_stats_stacked(*st_args)
            # At S = 16 the plain version's [Tp, K, lanes] intermediates of the
            # whole batch outgrow the card: it is held on the first 128
            # lanes there (every lane's counts are its own).
            lanes = NL if S == 4 else 128
            sub = (st_args[0][..., :lanes], st_args[1][..., :lanes], train.pair2[:, :lanes],
                   train.lens2[:, :lanes], tabs, B_reds, gts32, st_args[7][..., :lanes],
                   st_args[8][..., :lanes], st_args[9][:, :lanes])
            sub = tuple(x.contiguous() for x in sub)
            want, plain_ms = plain_once(plain, lambda: list(FB.oh_seq_stats_stacked_plain(*sub)))
            got_sub = [g[..., :lanes] for g in got]
            per = True
            for m in range(M):
                single = FB.oh_seq_stats(al[m], be[m], train.pair2, train.lens2, one(m),
                                         B_reds[m], gts32[m], zeros(K, NL), zeros(2, NL),
                                         zeros(1, NL))
                per = per and all(torch.equal(a, b[m]) for a, b in zip(single, got))
            single_ms = time_ms(lambda: FB.oh_seq_stats(
                al[0], be[0], train.pair2, train.lens2, one(0), B_reds[0], gts32[0],
                zeros(K, NL), zeros(2, NL), zeros(1, NL)), runs=10)
            valid = int(np.minimum(lengths, Tp).sum())  # B25 reads valid steps only
            st_row = _stacked_row(
                "oh_seq_stats_stacked", S, M, "train", got_sub, want, per,
                lambda: FB.oh_seq_stats_stacked(*st_args), plain_ms, single_ms,
                # per member alphas + betas at the valid steps; the pair once
                M * (16 * valid + (K * K + 2 * S + 1) * NL * 4) + 4 * valid + 4 * NL,
                M * 40 * valid, valid, tol=(1e-5, 1e-3), plain_lanes=lanes)
            del al, be, got, want, st_args, sub, got_sub
            if (S, M) == (4, 2):
                results |= {"oh_prod_stacked": row, "oh_fwdbwd_stacked": fwd_row,
                            "oh_seq_stats_stacked": st_row}
        del post, train
        torch.cuda.empty_cache()
    return results


def _captured(fn, module, name: str):
    """(fn(), (arguments, result) of the last call it makes to module.name)."""
    orig, seen = getattr(module, name), []

    def spy(*args):
        out = orig(*args)
        seen.append((args, out))
        return out

    setattr(module, name, spy)
    try:
        out = fn()
    finally:
        setattr(module, name, orig)
    return out, seen[-1]


def wall_s(fn, runs: int = 5) -> float:
    """Median host seconds of ``fn`` (one that returns a host value, so each
    call ends synchronized) over ``runs`` calls after one warm call."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _scoring_sublanes(name: str, args) -> int:
    """G of the scoring kernel ``name`` on ``args`` (loglik.loglik_sublanes)."""
    Tp = args[0].shape[0]
    if name == "oh_loglik":
        return LL.loglik_sublanes(Tp)
    return LL.loglik_sublanes(Tp, args[2].shape[0])


def _scoring_lanes_per_block(name: str, args) -> int:
    """The lanes a block of the scoring kernel ``name`` holds on ``args``
    where G > 1 (loglik._lanes_per_block)."""
    M = args[1].shape[0] if name == "oh_loglik" else 1
    sms = torch.cuda.get_device_properties(args[0].device).multi_processor_count
    return LL._lanes_per_block(args[0].shape[1], M, sms)


def scoring_g1(name: str, args, check: bool = True) -> dict:
    """The scoring kernel ``name`` on ``args`` in one sub-lane (G = 1): its
    lane sums (``out``) and time, and where ``check``, its plain version's
    time and agreement (rtol 1e-12)."""
    kernel, plain = getattr(LL, name), getattr(LL, f"{name}_plain")
    with loglik_sublane_length(args[0].shape[0]):
        out = kernel(*args)
        row = {"g1_ms": time_ms(lambda: kernel(*args), runs=10)}
        if check:
            want, row["g1_plain_ms"] = timed_once(lambda: plain(*args))
            row["g1_agrees"] = bool(torch.allclose(out, want, rtol=1e-12, atol=0))
    return row | {"out": out}


def scoring_sweep(name: str, args, g1: torch.Tensor) -> dict:
    """The scoring kernel ``name`` on ``args`` at each SWEEP_LOGLIK_SUBLANE_T:
    G, time and the largest relative difference of its lane sums from the
    G = 1 sums ``g1``."""
    kernel = getattr(LL, name)
    sweep = {}
    for st in SWEEP_LOGLIK_SUBLANE_T:
        with loglik_sublane_length(st):
            got = kernel(*args)
            sweep[str(st)] = {"G": _scoring_sublanes(name, args),
                              "ms": time_ms(lambda: kernel(*args), runs=10),
                              "max_rel_vs_g1": max_rel_diff(got, g1)}
    return sweep


def scoring_shape(name: str, params, obs: torch.Tensor, label: str) -> dict:
    """The scoring kernel at the shape ``sequence_loglik`` gives it on
    ``obs`` (compare's records): at its default G against its plain version
    (rtol 1e-12), timed beside G = 1, the sweep and the record in lanes of
    512 steps (kernel and whole ``sequence_loglik``)."""
    ll, (args, _) = _captured(lambda: LL.sequence_loglik(params, obs), LL, name)
    kernel, plain = getattr(LL, name), getattr(LL, f"{name}_plain")
    got = kernel(*args)
    agree = bool(torch.allclose(got, plain(*args), rtol=1e-12, atol=0))
    g1 = scoring_g1(name, args, check=False)
    _, (args512, _) = _captured(lambda: LL.sequence_loglik(params, obs, lane_T=512), LL, name)
    row = {"shape": label, "Tp": args[0].shape[0], "NL": args[0].shape[1],
           "G": _scoring_sublanes(name, args),
           "lanes_per_block": _scoring_lanes_per_block(name, args), "agrees": agree,
           "ms": time_ms(lambda: kernel(*args), runs=10), "g1_ms": g1["g1_ms"],
           "max_rel_vs_g1": max_rel_diff(got, g1["out"]), "loglik": ll,
           "sequence_loglik_wall_s": wall_s(lambda: LL.sequence_loglik(params, obs)),
           "sweep": scoring_sweep(name, args, g1["out"]),
           "lane512": {"ms": time_ms(lambda: kernel(*args512), runs=10),
                       "sequence_loglik_wall_s": wall_s(
                           lambda: LL.sequence_loglik(params, obs, lane_T=512))}}
    if not (agree and np.isfinite(ll)):
        raise SystemExit(f"chip_smoke: {name} at {label} disagrees with its plain version, or "
                         f"scored {ll}")
    return row


def scoring_stacked(obs: torch.Tensor, dev) -> None:
    """The reduced scoring kernel for a stacked group (the flagship and two
    random partition=2 members, M = 3) on the genome record's lanes: one
    launch, each member's lane sums equal to its own M = 1 launch bit for
    bit, timed beside M single launches."""
    members = family_members(torch.Generator().manual_seed(15), dev, 4, 3)
    _, (args, got) = _captured(lambda: LL.sequence_loglik_stacked(members, obs), LL,
                               "oh_loglik")
    pair2, enter, tabs = args
    singles = [(pair2, enter[m : m + 1].contiguous(), tabs[m : m + 1].contiguous())
               for m in range(len(members))]
    equal = all(torch.equal(LL.oh_loglik(*a)[0], got[m]) for m, a in enumerate(singles))
    emit({"phase": "scoring_stacked", "M": len(members), "Tp": pair2.shape[0],
          "NL": pair2.shape[1], "G": LL.loglik_sublanes(pair2.shape[0]),
          "lanes_per_block": _scoring_lanes_per_block("oh_loglik", args),
          "members_equal_single": equal,
          "ms": time_ms(lambda: LL.oh_loglik(*args), runs=10),
          "single_ms": [time_ms(lambda a=a: LL.oh_loglik(*a), runs=10) for a in singles]})
    if not equal:
        raise SystemExit("chip_smoke: a stacked scoring member differs from its own launch")


def scoring_kernel_phase(big: np.ndarray, dev) -> dict:
    """The scoring kernels on the genome's 64 Mi record (the lanes of the
    posterior, 8,192 x 8,192: G = 32 sub-lanes of 256 steps) for the
    flagship (reduced chain), two_state and null (dense chain, K = 2 and 1):
    the kernels against their plain versions on the same lanes (rtol 1e-12
    per lane: the float32 chains bit for bit, the float64 logs to their
    last bits), at their default G and in one sub-lane (G = 1), the sweep
    of SWEEP_LOGLIK_SUBLANE_T, the same record through the kernels in lanes
    of 512 steps (G = 1: the bar the sub-lanes must beat), compare's shapes
    (one placed 16 Ki record, NL = 2; the 8 Mi record, NL = 1,024) at G > 1
    and G = 1, a stacked group's members against their own launches, and
    the whole sequence_loglik on a 4 Mi prefix through the kernels and
    through the plain chains (rtol 1e-5).  Returns the rows: the flagship's
    oh_loglik and two_state's fb_loglik."""
    results = {}
    obs = torch.from_numpy(big).to(dev)
    for model, params in (("durbin8", presets.durbin_cpg8(device=dev)),
                          ("two_state", presets.two_state_cpg(device=dev)),
                          ("null", presets.null_background(4, device=dev))):
        name = "oh_loglik" if LL.scoring_engine(params) == "onehot" else "fb_loglik"
        LL.sequence_loglik(params, obs[: 1 << 20])  # warm
        ll, (args, _) = _captured(lambda: LL.sequence_loglik(params, obs), LL, name)
        wall = wall_s(lambda: LL.sequence_loglik(params, obs))
        kernel, plain = getattr(LL, name), getattr(LL, f"{name}_plain")
        got = kernel(*args)
        want, plain_ms = timed_once(lambda: plain(*args))
        agree = bool(torch.allclose(got, want, rtol=1e-12, atol=0))
        g1 = scoring_g1(name, args)
        sweep = scoring_sweep(name, args, g1["out"])
        ll512, (args512, _) = _captured(lambda: LL.sequence_loglik(params, obs, lane_T=512),
                                        LL, name)
        wall512 = wall_s(lambda: LL.sequence_loglik(params, obs, lane_T=512))
        ms512 = time_ms(lambda: kernel(*args512), runs=10)
        del args512
        shapes = [scoring_shape(name, params, obs[:n], label)
                  for n, label in ((16 << 10, "placed 16 Ki record"),
                                   (COMPARE_SYMBOLS, "compare's 8 Mi record"))]
        Tp, NL = args[0].shape
        real = int((args[0] < (params.n_symbols ** 2 if name == "oh_loglik"
                               else params.n_symbols)).sum())
        K = params.n_states
        f32 = 10 * real if name == "oh_loglik" else (2 * K * K + 2 * K + 1) * real
        # The bound's operations: the float32 chain, and the float64 log and
        # add of every real step at the float64 rate, as float32-time.
        ops = f32 + real * (LOG_F64_OPS + 1) * F32_OPS_PER_S / F64_OPS_PER_S
        row = kernel_row(name, agree, max_abs_err(got, want), lambda: kernel(*args), plain_ms,
                         4 * Tp * NL + 4 * args[1].numel() + 8 * got.numel(), ops, Tp * NL,
                         model=model, K=K, sublanes=_scoring_sublanes(name, args),
                         lanes_per_block=_scoring_lanes_per_block(name, args),
                         tolerance="rtol 1e-12 per lane", record_symbols=int(big.size),
                         loglik=ll, sequence_loglik_wall_s=wall,
                         g1_ms=g1["g1_ms"], g1_plain_ms=g1["g1_plain_ms"],
                         g1_agrees=g1["g1_agrees"],
                         max_rel_vs_g1=max_rel_diff(got, g1["out"]), sweep=sweep,
                         lane512={"ms": ms512, "sequence_loglik_wall_s": wall512,
                                  "loglik": ll512},
                         compare_shapes=shapes)
        if not (agree and g1["g1_agrees"] and np.isfinite(ll)):
            raise SystemExit(f"chip_smoke: the {model} scoring kernel disagrees with its plain "
                             f"version, or scored {ll}")
        prefix = obs[:PARITY_SYMBOLS]
        ll_k = LL.sequence_loglik(params, prefix)
        orig = getattr(LL, name)
        setattr(LL, name, plain)
        try:
            ll_p = LL.sequence_loglik(params, prefix)
        finally:
            setattr(LL, name, orig)
        emit({"phase": "scoring_parity", "model": model, "symbols": PARITY_SYMBOLS,
              "loglik_kernel": ll_k, "loglik_plain": ll_p,
              "rel_diff": abs(ll_k - ll_p) / abs(ll_p)})
        if not abs(ll_k - ll_p) <= 1e-5 * abs(ll_p):
            raise SystemExit(f"chip_smoke: {model} scores differently through the plain chain")
        if model in ("durbin8", "two_state"):
            results[name] = row
    scoring_stacked(obs, dev)
    return results


def compare_casts(gen: torch.Generator, model_path: str) -> list:
    """(label, members, stacked) of the compare main path: the default cast,
    the flagship against the flagship that ``run`` trained (a stacked group)
    stacked and not, and an order-2 cast with a random K = 32 pair member
    (a stacked group on the pair alphabet)."""
    b = family.builtin_member
    trained = [b("durbin8"), family.member_from_params("trained", load_text(model_path)),
               b("two_state"), b("null")]
    rand32 = family.member_from_params("rand32", presets.random_hmm(gen, 32, 16, partition=2))
    return [("default", family.default_members(), True), ("trained", trained, True),
            ("trained", trained, False), ("order2", [b("dinuc_cpg"), rand32, b("null16")], True)]


def check_comparison(res, label: str) -> None:
    ok = res.n_records > 0
    for rc in res.records:
        for m in rc.members:
            ok = ok and np.isfinite(m.loglik) and np.isfinite(m.log_odds)
            ok = ok and (m.conf.shape == (rc.n_symbols,)) and bool(np.all(np.isfinite(m.conf)))
            ok = ok and bool(np.all((m.conf >= 0) & (m.conf <= 1 + 1e-6)))
    calls = sum(len(rc.winner_calls) for rc in res.records)
    if not (ok and calls > 0):
        raise SystemExit(f"chip_smoke: compare ({label}) gave non-finite or out-of-range results "
                         f"or no winner-track islands ({calls})")


def compare_fasta(rng: np.random.Generator, tmp: str, big: np.ndarray) -> str:
    """compare's input: the big record's first COMPARE_SYMBOLS symbols
    (N-led, as in the genome) plus COMPARE_SCAFFOLDS scaffolds drawn as the
    genome's are."""
    path = os.path.join(tmp, "compare.fa")
    with open(path, "wb") as f:
        f.write(to_fasta_bytes(rng, "chr1", big[:COMPARE_SYMBOLS], lead_n=BIG_LEAD_N))
        sizes = np.exp(rng.uniform(np.log(2 << 10), np.log(512 << 10), size=COMPARE_SCAFFOLDS))
        for i, m in enumerate(sizes.astype(np.int64)):
            f.write(to_fasta_bytes(rng, f"scaffold{i}", make_sequence(rng, int(m))))
    return path


def compare_phase(fa: str, tmp: str, dev, casts: list) -> dict:
    """compare_file over ``fa`` (compare_fasta's) for each cast; a run with a stacked
    group launches B21 and B24 (and no B7 or B4: every reduced member of
    these casts is grouped), any other run B7 and B4 and no stacked kernel,
    every run both scoring kernels, and the stacked and sequential reports
    are byte-identical.  Returns the launch counts of
    every run together."""
    launches: dict = {}
    reports = {}
    for label, members, stacked in casts:
        arm = "stacked" if stacked else "sequential"
        out = os.path.join(tmp, f"compare.{label}.{arm}.txt")
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = pipeline.compare_file(fa, members, out=out, stacked=stacked, device=dev)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _kernels.launches.items() if v}
        check_comparison(res, f"{label} {arm}")
        big = max(res.records, key=lambda rc: rc.n_symbols)
        emit({"phase": "compare", "cast": label, "arm": arm, "models": res.member_names,
              "symbols": res.n_symbols, "records": res.n_records, "wall_s": wall,
              "phases_s": res.phases, "msym_per_s": res.n_symbols / wall / 1e6,
              "winner_islands": sum(len(rc.winner_calls) for rc in res.records),
              "big_record": {m.name: {"loglik": m.loglik, "log_odds": m.log_odds,
                                      "islands": len(m.calls)} for m in big.members},
              "launches": counts})
        engines = [None if m.is_null else resolve_fb_engine("auto", m.params) for m in members]
        if stack_groups(members, engines, enabled=stacked):
            bad = (any(counts.get(k, 0) == 0 for k in ("oh_prod_stacked", "oh_fwdbwd_stacked"))
                   or counts.get("oh_prod", 0) or counts.get("oh_fwdbwd", 0))
        else:
            bad = (any(counts.get(k, 0) == 0 for k in ("oh_prod", "oh_fwdbwd"))
                   or any(counts.get(k, 0) for k in STACKED_KERNELS))
        if bad or not counts.get("oh_loglik") or not counts.get("fb_loglik"):
            raise SystemExit(f"chip_smoke: compare ({label}, {arm}) launched {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        with open(out) as f:
            reports[(label, arm)] = f.read()
    same = reports[("trained", "stacked")] == reports[("trained", "sequential")]
    emit({"phase": "compare_arms", "cast": "trained", "reports_identical": same,
          "lines": reports[("trained", "stacked")].count("\n")})
    if not same:
        raise SystemExit("chip_smoke: the stacked and sequential compare reports differ")
    return launches


def _model_lines(report: str) -> list:
    return [ln.split() for ln in report.splitlines() if ln.startswith("# model ")]


def compare_parity_phase(rng: np.random.Generator, big: np.ndarray, tmp: str, dev,
                         casts: list) -> None:
    """A small FASTA compared on the CPU and on the card (the stacked cast):
    the winner-track and record lines byte-identical, each model's loglik
    and log-odds within rtol 1e-5 of the logliks; then the dinuc lift on a
    4 Mi prefix of the genome: ll(flagship) - log 4 = ll(dinuc_cpg) within
    1e-5 relative, and the two confidence tracks within 1e-3."""
    fa = os.path.join(tmp, "compare_small.fa")
    with open(fa, "wb") as f:
        for i, n in enumerate((9_000, 23_000, 4_000)):
            f.write(to_fasta_bytes(rng, f"c{i}", make_sequence(rng, n)))
    members = next(m for label, m, stacked in casts if label == "trained")
    out = []
    for where in ("cpu", dev):
        buf = io.StringIO()
        pipeline.compare_file(fa, members, out=buf, device=where)
        out.append(buf.getvalue())
    rest = [[ln for ln in r.splitlines() if not ln.startswith("# model ")] for r in out]
    mc, mg = _model_lines(out[0]), _model_lines(out[1])
    err = 0.0
    for a, b in zip(mc, mg):
        ll_scale = abs(float(a[4]))
        err = max(err, abs(float(a[4]) - float(b[4])) / ll_scale,
                  abs(float(a[6]) - float(b[6])) / ll_scale)
    same = rest[0] == rest[1] and [x[:4] + x[7:] for x in mc] == [x[:4] + x[7:] for x in mg]
    emit({"phase": "compare_cpu_vs_cuda", "lines_identical": same, "lines": len(rest[1]),
          "max_rel_err": err})
    if not (same and len(mc) == len(mg) and err <= 1e-5):
        raise SystemExit("chip_smoke: compare on the CPU and on the card disagree")

    obs = big[:PARITY_SYMBOLS]
    rc = family.compare_record([family.builtin_member("durbin8"),
                                family.builtin_member("dinuc_cpg")], obs, device=dev)
    fl, di = rc.members
    lift = abs((fl.loglik - np.log(4.0)) - di.loglik) / abs(fl.loglik)
    c_err = float(np.abs(fl.conf.astype(np.float64) - di.conf).max())
    emit({"phase": "dinuc_lift", "symbols": PARITY_SYMBOLS, "loglik_flagship": fl.loglik,
          "loglik_dinuc": di.loglik, "rel_err": lift, "max_conf_err": c_err})
    if not (lift <= 1e-5 and c_err <= 1e-3):
        raise SystemExit("chip_smoke: dinuc_cpg is not the flagship's pair lift")


def fit_family_phase(gen: torch.Generator, fa: str, dev) -> dict:
    """fit_family of FAMILY_M reduced members (the flagship and random
    partition=2 members) on the genome's training batch, TRAIN_ITERS
    iterations: B24 and B25 once per iteration, B4 and B5 never, and every
    member's trajectory and model equal to its own baum_welch.fit bit for
    bit; then profiles of one stacked E-step and of the sequential arm.
    Returns the launch counts of the fit_family run."""
    chunked = chunking.frame(codec.encode_file(fa), chunking.TRAIN_CHUNK, drop_remainder=True)
    members = family_members(gen, dev, 4, FAMILY_M)
    chunks, lengths = LocalBackend().place(chunked, dev)
    fit_family(members, chunks, lengths, n_iter=1)  # warm
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, hist = fit_family(members, chunks, lengths, n_iter=TRAIN_ITERS)
    wall = time.perf_counter() - t0
    counts = {k: _kernels.launches[k] for k in STACKED_KERNELS + SINGLE_FB_KERNELS}
    solo = [baum_welch.fit(p, chunked, num_iters=TRAIN_ITERS, convergence=0.0, engine="onehot")
            for p in members]
    ll_same = [bool(np.array_equal(hist[:, m], np.asarray(r.logliks, np.float64)))
               for m, r in enumerate(solo)]
    params_same = [all(torch.equal(getattr(fitted[m], f), getattr(r.params, f))
                       for f in ("log_pi", "log_A", "log_B")) for m, r in enumerate(solo)]
    same = all(ll_same) and all(params_same)
    symbols = int(chunked.total)
    emit({"phase": "fit_family", "M": FAMILY_M, "chunks": chunked.num_chunks, "symbols": symbols,
          "iterations": TRAIN_ITERS, "wall_s": wall,
          "em_msym_per_s_times_m": symbols * TRAIN_ITERS * FAMILY_M / wall / 1e6,
          "solo_em_s": [r.phases["em"] for r in solo], "logliks": hist.tolist(),
          "equals_solo_fits": same, "logliks_equal": ll_same, "models_equal": params_same,
          "solo_logliks": [r.logliks for r in solo], "launches": counts})
    if not same:
        raise SystemExit("chip_smoke: fit_family differs from the members' own fits")
    if (counts["oh_fwdbwd_stacked"] != TRAIN_ITERS or counts["oh_seq_stats_stacked"] != TRAIN_ITERS
            or counts["oh_fwdbwd"] or counts["oh_seq_stats"]):
        raise SystemExit(f"chip_smoke: fit_family launched {counts}")
    for stacked in (True, False):
        estep = FamilyEStep(stacked=stacked)
        prep = estep.prepare_streams(members, chunks, lengths)
        estep(members, chunks, lengths, prepared=prep)
        profiled(f"one family E-step, M={FAMILY_M}, {'stacked' if stacked else 'sequential'}, "
                 f"{chunked.num_chunks} chunks of {chunking.TRAIN_CHUNK}",
                 lambda: [st.loglik for st in estep(members, chunks, lengths, prepared=prep)])
    return counts


# ---------------------------------------------------------------------------
# Phases 21-23: flat-batch scores (B6), the span-wise decode, device islands
# in the posterior (phase 7 and 15 runs)


FLAT_KERNELS = ("oh_products", "oh_backpointers_scores", "oh_backtrace")


def scores_phase(params, fa: str, dev) -> dict:
    """``viterbi_parallel_batch(engine="onehot")`` over the genome's
    scaffolds, one padded batch: per-record scores through B6.  The same
    batch then runs with B1, B6 and B3 swapped for their plain versions on
    the card: paths and scores must be equal bit for bit, and so must B6's
    inputs and all four of its outputs at the main path's shape.  Each
    score must also lie within f32 rounding of the record's own
    ``viterbi_parallel`` score and of a float64 re-score of its path: 64
    ulps of its stream magnitude |M_r| (the telescoped chain max it is a
    first difference of, carried through about 2 log2(nb) rounded
    block-offset combines) plus 5e-5 of the score (the f32 chain inside
    each block: at most half an ulp of its ~6e3-nat range a step, 1.7e-4
    of the score).  Returns the launch counts of the batch call."""
    from cpgisland_tpu_torch.ops.viterbi_parallel import viterbi_parallel, viterbi_parallel_batch

    recs = [s for name, s in codec.iter_fasta_records(fa) if name != "chr1"]
    N, T = len(recs), pipeline._round_pow2(max(r.size for r in recs))
    rows = np.full((N, T), chunking.PAD_SYMBOL, np.uint8)
    for i, r in enumerate(recs):
        rows[i, : r.size] = r
    lengths = np.array([r.size for r in recs], np.int32)
    rows_d, lengths_d = torch.from_numpy(rows).to(dev), torch.from_numpy(lengths).to(dev)

    def batch():
        return _captured(lambda: viterbi_parallel_batch(params, rows_d, lengths_d,
                                                         engine="onehot"),
                         OH, "oh_backpointers_scores")

    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (paths_d, scores_d), (b6_in, b6_out) = batch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: _kernels.launches[k] for k in DECODE_KERNELS + ("oh_backpointers_scores",)}
    kernels = {k: getattr(OH, k) for k in FLAT_KERNELS}
    for k in FLAT_KERNELS:
        setattr(OH, k, getattr(OH, f"{k}_plain"))
    try:
        (paths_p, scores_p), (b6_in_p, b6_out_p) = batch()
    finally:
        for k, f in kernels.items():
            setattr(OH, k, f)
    b6_equal = all(torch.equal(a, b) for a, b in zip(b6_in + b6_out, b6_in_p + b6_out_p))
    b6_err = max(max_abs_err(a, b) for a, b in zip(b6_out, b6_out_p))
    plain_equal = torch.equal(paths_d, paths_p) and torch.equal(scores_d, scores_p)
    b6_shape = list(b6_out[3].shape)  # dmax2 [bk, nb]
    del b6_in, b6_out, b6_in_p, b6_out_p, paths_p, scores_p
    paths, scores = paths_d.cpu().numpy(), scores_d.double().cpu().numpy()
    mag = np.abs(np.cumsum(scores)).astype(np.float32)
    bound = 64 * np.spacing(mag).astype(np.float64) + 5e-5 * np.abs(scores)
    gap_own = np.zeros(N)
    gap_f64 = np.zeros(N)
    for i, r in enumerate(recs):
        _, own = viterbi_parallel(params, torch.from_numpy(r).to(dev))
        gap_own[i] = abs(scores[i] - float(own))
        gap_f64[i] = abs(scores[i] - path_score_f64(params, r, paths[i, : r.size]))
    ratio = np.maximum(gap_own, gap_f64) / bound
    worst = int(np.argmax(ratio))
    emit({"phase": "flat_scores", "records": N, "T": T, "symbols": int(lengths.sum()),
          "wall_s": wall, "launches": counts, "b6_shape": b6_shape,
          "b6_equals_plain": b6_equal, "b6_max_abs_err": b6_err,
          "paths_scores_equal_plain": plain_equal, "max_stream_magnitude": float(mag.max()),
          "max_bound": float(bound.max()), "max_gap_vs_own_decode": float(gap_own.max()),
          "max_gap_vs_f64_rescore": float(gap_f64.max()),
          "max_gap_over_bound": float(ratio[worst]),
          "tightest": {"record": worst, "length": int(lengths[worst]),
                       "score": float(scores[worst]), "magnitude": float(mag[worst]),
                       "bound": float(bound[worst]), "gap_own": float(gap_own[worst]),
                       "gap_f64": float(gap_f64[worst])},
          "scores_finite": bool(np.isfinite(scores).all())})
    if (counts["oh_backpointers_scores"] != 1 or counts["oh_backpointers"]
            or not np.isfinite(scores).all() or not b6_equal or not plain_equal
            or (gap_own > bound).any() or (gap_f64 > bound).any()):
        raise SystemExit("chip_smoke: the flat-batch scores are off or skipped B6")
    return counts


def span_decode_phase(params, big: np.ndarray, tmp: str, dev) -> dict:
    """One record of 2^28 + 2^25 symbols (the default span, CLEAN_DECODE_SPAN
    = 2^28, and an eighth: the big record's sequence repeated), an island
    planted across the span boundary, decoded clean with device islands at
    the default span (2 spans) and in one pass (span 2^29): identical
    island files, the boundary island whole.  Then the two decodes alone,
    to the card's path, in turns (one pass, spans, spans, one pass).
    Returns the launch counts of the span-wise run."""
    boundary = pipeline.CLEAN_DECODE_SPAN
    n = boundary + boundary // 8
    fa = os.path.join(tmp, "long.fa")
    t0 = time.perf_counter()
    s = np.resize(big, n)
    lo = boundary - 1500
    s[lo : lo + 3000] = np.random.default_rng(7).choice(4, size=3000, p=_STRONG_ISLAND)
    text = np.frombuffer(b"ACGT", np.uint8)[s]
    full = text.size // 60
    with open(fa, "wb") as f:
        f.write(b">chrL synthetic\n")
        f.write(np.concatenate([text[: full * 60].reshape(full, 60),
                                np.full((full, 1), ord("\n"), np.uint8)], axis=1).tobytes())
        f.write(text[full * 60 :].tobytes() + b"\n")
    del text
    emit({"phase": "span_fasta", "symbols": n, "bytes": os.path.getsize(fa),
          "seconds": time.perf_counter() - t0})
    out, counts = {}, None
    for label, span in (("spans", boundary), ("one_pass", 2 * boundary)):
        isl = os.path.join(tmp, f"long.{label}.txt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches = decode_to(fa, params, isl, dev, span=span)
        peak = torch.cuda.max_memory_allocated()
        with open(isl) as f:
            out[label] = f.read()
        emit({"phase": "span_decode", "mode": label, "span": span, "symbols": res.n_symbols,
              "spans": res.n_chunks, "islands": len(res.calls), "wall_s": wall,
              "phases_s": res.phases, "msym_per_s": res.n_symbols / wall / 1e6,
              "decode_msym_per_s": res.n_symbols / res.phases["decode"] / 1e6,
              "peak_device_bytes": peak,
              "launches": {k: launches[k] for k in DECODE_KERNELS}})
        if label == "spans":
            counts = launches
            if res.n_chunks != 2 or any(launches[k] == 0 for k in DECODE_KERNELS):
                raise SystemExit(f"chip_smoke: the long record ran {res.n_chunks} spans and "
                                 f"launched {launches}")
        os.remove(isl)
    os.remove(fa)
    rows = [ln.split() for ln in out["spans"].splitlines()]
    near = [r for r in rows if abs(int(r[0]) - boundary) < 5000]
    whole = any(int(r[0]) <= boundary - 500 and int(r[1]) >= boundary + 500 for r in near)
    same = out["spans"] == out["one_pass"]
    emit({"phase": "span_decode_parity", "identical": same, "lines": len(rows),
          "boundary_calls": near, "boundary_island_whole": whole})
    if not (same and whole and rows):
        raise SystemExit("chip_smoke: the span-wise decode differs from the one-pass decode "
                         "or split the boundary island")

    decodes = {
        "one_pass": lambda: viterbi_sharded(params, s, return_device=True),
        "spans": lambda: torch.cat(viterbi_sharded_spans(params, s, span=boundary,
                                                         return_device=True)),
    }
    seconds = {k: [] for k in decodes}
    for label in ("one_pass", "spans", "spans", "one_pass"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = decodes[label]()
        torch.cuda.synchronize()
        seconds[label].append(time.perf_counter() - t0)
        del path
    emit({"phase": "span_decode_timing", "symbols": n, "seconds": seconds,
          "spans_over_one_pass": sum(seconds["spans"]) / sum(seconds["one_pass"])})
    return counts


def genome_span_phase(fa: str, tmp: str, dev) -> None:
    """The genome decoded clean at a 16 Mi span (its 64 Mi record in 4
    spans), flagship and two_state: island files identical to the
    one-pass runs of phases 3 and 10."""
    runs = (("clean", presets.durbin_cpg8, {}), ("two_state", presets.two_state_cpg,
                                                  {"island_states": (0,)}))
    for label, make, kw in runs:
        isl = os.path.join(tmp, f"islands.{label}.span16Mi.txt")
        res, wall, launches = decode_to(fa, make(device=dev), isl, dev, span=1 << 24, **kw)
        with open(isl) as f, open(os.path.join(tmp, f"islands.{label}.device.txt")) as g:
            same = f.read() == g.read()
        emit({"phase": "genome_span_decode", "mode": label, "span": 1 << 24,
              "spans": res.n_chunks, "identical_to_one_pass": same, "wall_s": wall,
              "phases_s": res.phases, "launches": launches})
        if not same or res.n_chunks <= 257:
            raise SystemExit(f"chip_smoke: the {label} span-wise genome decode differs "
                             "from the one-pass decode")


# ---------------------------------------------------------------------------
# Phases 24-29: whole-sequence EM (SeqBackend, Seq2DBackend), the device EM
# loop and the one-pass arm (B8)


def mat_kernel_phase(rng: np.random.Generator, params, big: np.ndarray, dev) -> dict:
    """B8 at a ragged geometry (odd lane lengths, empty lanes) and at the
    posterior's 8192 x 8192 on the pair stream of the genome's 64 Mi
    record: va and wb bit-equal to the plain version; B8 timed beside B7
    and B4 on the same lanes."""
    S = params.n_symbols
    tab = FB.prob_tab_ext(params, OH._groups(params))
    n = 3000 * 1237
    obs = torch.from_numpy(rng.integers(0, S, size=n).astype(np.uint8)).to(dev)
    prep = prepare_seq(S, obs, n - 77, lane_T=1237)
    NL = prep.pair2.shape[1]
    lens = rng.integers(0, 1238, size=NL).astype(np.int32)
    lens[rng.random(NL) < 0.1] = 0
    lens2 = torch.from_numpy(lens[None, :]).to(dev)
    args = (prep.pair2, prep.pairn2, lens2, tab, 1237)
    (vk, wk), (vp, wp) = FB.oh_fwdbwd_mat(*args), FB.oh_fwdbwd_mat_plain(*args)
    ragged_equal = torch.equal(vk, vp) and torch.equal(wk, wp)
    emit({"phase": "kernel_ragged", "name": "oh_fwdbwd_mat", "lanes": NL, "lane_T": 1237,
          "empty_lanes": int((lens == 0).sum()), "bit_equal": ragged_equal,
          "max_abs_err": max(max_abs_err(vk, vp), max_abs_err(wk, wp))})
    if not ragged_equal:
        raise SystemExit("chip_smoke: oh_fwdbwd_mat disagrees with its plain version (ragged)")

    T = POST_NL * POST_LANE_T
    obs = torch.from_numpy(big[:T]).to(dev)
    prep = prepare_seq(S, obs, T, lane_T=POST_LANE_T)
    lens2 = prep.lane_lens[None, :].contiguous()
    args = (prep.pair2, prep.pairn2, lens2, tab, POST_LANE_T)
    vk, wk = FB.oh_fwdbwd_mat(*args)
    (vp, wp), plain_ms = timed_once(lambda: FB.oh_fwdbwd_mat_plain(*args))
    equal = torch.equal(vk, vp) and torch.equal(wk, wp)
    err = max(max_abs_err(vk, vp), max_abs_err(wk, wp))
    del vp, wp, vk, wk
    steps_n = T
    v = torch.ones((2, POST_NL), dtype=torch.float32, device=dev)
    b7_ms = time_ms(lambda: FB.oh_prod(prep.pair2, tab), runs=10)
    b4_ms = time_ms(lambda: FB.oh_fwdbwd(prep.pair2, prep.pairn2, lens2, v, v, tab,
                                         POST_LANE_T), runs=10)
    real = int(prep.lane_lens.sum())
    row = kernel_row(
        "oh_fwdbwd_mat", equal, err, lambda: FB.oh_fwdbwd_mat(*args), plain_ms,
        # pair + pairn read, va + wb written (4 f32 rows each), per step; per
        # real step 8 multiplies, 7 adds and a division a direction
        n_bytes=8 * steps_n + 32 * steps_n + 4 * POST_NL + tab.numel() * 4,
        n_ops=2 * 16 * real, steps=steps_n, bit_equal=equal, b7_ms=b7_ms, b4_ms=b4_ms,
        b7_plus_b4_ms=b7_ms + b4_ms, geometry="genome 64 Mi record, 8192 x 8192",
    )
    if not equal:
        raise SystemExit("chip_smoke: oh_fwdbwd_mat disagrees with its plain version")
    return {"oh_fwdbwd_mat": row}


def _models_close(a, b, atol: float = MODEL_ATOL) -> tuple:
    err = max(float(np.abs(x - y).max()) for x, y in zip(probs(a), probs(b)))
    zeros = all(np.array_equal(x == 0, y == 0) for x, y in zip(probs(a), probs(b)))
    return err, err <= atol and zeros


def seq_train_phase(fa: str, dev) -> tuple:
    """train_file clean, TRAIN_ITERS iterations, convergence 0 (the device
    loop), with the whole-sequence backends: the flagship through seq (two
    pass) and SeqBackend(one_pass=True), two_state through seq, the flagship
    through seq2d.  Returns (launches over the runs, {label: result})."""
    from cpgisland_tpu_torch.train.backends import SeqBackend

    flagship, two = presets.durbin_cpg8(device=dev), presets.two_state_cpg(device=dev)
    runs = (
        ("seq", flagship, "seq", SEQ_KERNELS, ("oh_fwdbwd_mat",)),
        ("seq_one_pass", flagship, SeqBackend(one_pass=True), ONE_PASS_KERNELS,
         ("oh_prod", "oh_fwdbwd")),
        ("seq_two_state", two, "seq", DENSE_SEQ_KERNELS, SEQ_KERNELS + ("oh_fwdbwd_mat",)),
        ("seq2d", flagship, "seq2d", ("oh_fwdbwd", "oh_seq_stats"), ("oh_fwdbwd_mat",)),
        ("seq_split", flagship, SeqBackend(fuse_fb=False), SPLIT_SEQ_KERNELS,
         FUSED_CHAINS + ("oh_stats",)),
    )
    symbols = int(codec.encode_file(fa, skip_headers=True).size)
    launches, results = {}, {}
    for label, params, backend, kernels, absent in runs:
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = pipeline.train_file(fa, params=params, num_iters=TRAIN_ITERS, convergence=0.0,
                                  compat=False, backend=backend, device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = {k: n for k, n in _kernels.launches.items() if n}
        ll = res.logliks
        monotone = all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))
        emit({
            "phase": "seq_train", "run": label, "symbols": symbols,
            "iterations": res.iterations, "wall_s": wall, "phases_s": res.phases,
            "em_msym_per_s": symbols * res.iterations / res.phases["em"] / 1e6,
            "peak_device_bytes": peak,
            "estep_ms_per_iter": res.phases["estep"] / res.iterations * 1e3,
            "mstep_ms_per_iter": res.phases["mstep"] / res.iterations * 1e3,
            "logliks": ll, "deltas": res.deltas, "launches": counts,
        })
        ok_counts = (all(counts.get(k, 0) >= TRAIN_ITERS for k in kernels)
                     and not any(counts.get(k, 0) for k in absent))
        if label in ("seq", "seq_one_pass", "seq_two_state", "seq_split"):
            ok_counts = ok_counts and all(counts.get(k, 0) == TRAIN_ITERS for k in kernels)
        if res.iterations != TRAIN_ITERS or not ok_counts:
            raise SystemExit(f"chip_smoke: {label} training launched {counts}; want "
                             f"{kernels} every iteration and none of {absent}")
        if not monotone:
            raise SystemExit(f"chip_smoke: {label} training logliks decrease: {ll}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        results[label] = res
    two_pass, one_pass = results["seq"], results["seq_one_pass"]
    ll_ok = np.allclose(one_pass.logliks, two_pass.logliks, rtol=ONE_PASS_LL_RTOL, atol=0)
    err, model_ok = _models_close(one_pass.params, two_pass.params)
    emit({"phase": "one_pass_vs_two_pass", "max_ll_rel": float(np.max(np.abs(
        np.subtract(one_pass.logliks, two_pass.logliks)) / np.abs(two_pass.logliks))),
        "max_prob_err": err, "ok": bool(ll_ok and model_ok)})
    if not (ll_ok and model_ok):
        raise SystemExit("chip_smoke: the one-pass trajectory leaves the two-pass one")
    split = results["seq_split"]
    rel = float(np.max(np.abs(np.subtract(split.logliks, two_pass.logliks))
                       / np.abs(two_pass.logliks)))
    emit({"phase": "seq_split_vs_fused", "max_ll_rel": rel})
    if rel > SPLIT_LL_RTOL:
        raise SystemExit("chip_smoke: the split seq trajectory leaves the fused one")
    return launches, results


def _fit_result_equal(a, b) -> bool:
    same_params = all(torch.equal(x, y) for x, y in zip(
        (a.params.log_pi, a.params.log_A, a.params.log_B),
        (b.params.log_pi, b.params.log_A, b.params.log_B)))
    return (same_params and a.logliks == b.logliks and a.deltas == b.deltas
            and a.iterations == b.iterations and a.converged == b.converged)


def em_loop_phase(fa: str, dev, seq_results: dict) -> None:
    """The device loop against the host loop: the flagship seq and local
    runs bit-equal with fuse="off"; a real convergence threshold stops both
    at one iteration; blocking reads counted; each loop's idle share over
    TRAIN_ITERS iterations under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    params = presets.durbin_cpg8(device=dev)
    fetches = {"n": 0}
    real_fetch = baum_welch._fetch

    def counted(x):
        fetches["n"] += 1
        return real_fetch(x)

    baum_welch._fetch = counted
    try:
        kw = dict(params=params, num_iters=TRAIN_ITERS, convergence=0.0, compat=False,
                  device=dev)
        pairs = {}
        for backend in ("seq", "local"):
            fetches["n"] = 0
            on = pipeline.train_file(fa, backend=backend, fuse="on", **kw)
            on_fetches = fetches["n"]
            fetches["n"] = 0
            off = pipeline.train_file(fa, backend=backend, fuse="off", **kw)
            pairs[backend] = (_fit_result_equal(on, off), on_fetches, fetches["n"])
        conv = float(np.median(seq_results["seq"].deltas))
        stops = []
        for fuse in ("on", "off"):
            fetches["n"] = 0
            r = pipeline.train_file(fa, params=params, num_iters=10, convergence=conv,
                                    compat=False, backend="seq", fuse=fuse, device=dev)
            stops.append((r, fetches["n"]))
    finally:
        baum_welch._fetch = real_fetch
    (r_on, f_on), (r_off, f_off) = stops
    emit({"phase": "em_loop", "bit_equal": {k: v[0] for k, v in pairs.items()},
          "blocking_reads_device_loop": {k: v[1] for k, v in pairs.items()},
          "blocking_reads_host_loop": {k: v[2] for k, v in pairs.items()},
          "convergence": conv, "stop_iteration": [r_on.iterations, r_off.iterations],
          "converged": [r_on.converged, r_off.converged],
          "stop_reads": [f_on, f_off]})
    if not (all(v[0] and v[1] == 0 and v[2] == TRAIN_ITERS for v in pairs.values())
            and _fit_result_equal(r_on, r_off) and r_on.converged and f_on == 0
            and r_on.iterations < 10):
        raise SystemExit("chip_smoke: the device EM loop differs from the host loop")

    # Idle share: the two loops themselves, over one placed and prepared input.
    from cpgisland_tpu_torch.train.backends import SeqBackend

    chunked = chunking.frame(codec.encode_file(fa, skip_headers=True), chunking.TRAIN_CHUNK)
    for label, backend in (("seq", SeqBackend()), ("local", LocalBackend()),
                           ("seq_split", SeqBackend(fuse_fb=False)),
                           ("local_split", LocalBackend(fuse_fb=False))):
        prepared_in = backend.prepare(chunked)
        chunks, lengths = backend.place(prepared_in, dev)
        prep = backend.prepare_streams(params, chunks, lengths)

        def iteration(p, watch):
            watch.mark()
            stats = backend(p, chunks, lengths, prepared=prep)
            watch.mark()
            new_p, delta = baum_welch.em_update(p, stats)
            watch.mark()
            return new_p, delta, stats.loglik.float()

        for name, loop in (("host", baum_welch._host_loop), ("device", baum_welch._device_loop)):
            loop(params, iteration, baum_welch._Stopwatch(dev), 1, 0.0)  # warm
            torch.cuda.synchronize()
            # Every synchronizing CUDA call PyTorch makes inside the loop
            # (a D2H read, a pageable copy, a stream sync) warns here.
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    loop(params, iteration, baum_welch._Stopwatch(dev), TRAIN_ITERS, 0.0)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                loop(params, iteration, baum_welch._Stopwatch(dev), TRAIN_ITERS, 0.0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = sum(us for _, us, _ in device_rows(prof)) / 1e6
            emit({"phase": "em_loop_profile", "backend": label, "loop": name,
                  "iterations": TRAIN_ITERS, "wall_s": wall, "device_busy_s": busy,
                  "idle_share": 1.0 - busy / wall, "ms_per_iter": wall / TRAIN_ITERS * 1e3,
                  "synchronizing_calls": syncs})
            if name == "device" and syncs:
                raise SystemExit(f"chip_smoke: the device EM loop ({label}) made {syncs} "
                                 "synchronizing CUDA calls")


def seq_cpu_vs_card_phase(rng: np.random.Generator, tmp: str, dev) -> None:
    """A small FASTA trained by seq and seq2d on the CPU (the plain
    versions) and on the card (the kernels): text dumps compared byte for
    byte, and held to the repo's CPU-vs-card bound (atol 1e-5, the same
    structural zeros)."""
    fa = small_fasta(rng, os.path.join(tmp, "seq_small.fa"))
    for backend in ("seq", "seq2d"):
        dumps, models = {}, {}
        for where in ("cpu", dev):
            out = os.path.join(tmp, f"seq_small.{backend}.{where}.model")
            res = pipeline.train_file(fa, num_iters=2, convergence=0.0, compat=False,
                                      backend=backend, model_out=out, device=where)
            with open(out) as f:
                dumps[str(where)] = f.read()
            models[str(where)] = res.params
        err, ok = _models_close(models["cpu"], models[str(dev)])
        emit({"phase": "seq_cpu_vs_cuda", "backend": backend,
              "dumps_byte_identical": dumps["cpu"] == dumps[str(dev)],
              "max_prob_err": err, "within_1e-5": ok})
        if not ok:
            raise SystemExit(f"chip_smoke: {backend} training on the CPU and on the card "
                             "disagree")


def one_pass_posterior_phase(params, big: np.ndarray, dev) -> dict:
    """posterior_sharded on the 64 Mi record, one-pass (B8) against two-pass
    (B7 + B4): confidence within atol 2e-5, MPM paths compared, both timed."""
    obs = big[: POST_NL * POST_LANE_T]
    out, launches = {}, {}
    for one_pass in (False, True, True, False):
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conf, path = posterior_sharded(params, obs, ISLAND_STATES, want_path=True,
                                       one_pass=one_pass)
        wall = time.perf_counter() - t0
        out.setdefault(one_pass, (conf, path, []))[2].append(wall)
        launches[one_pass] = {k: n for k, n in _kernels.launches.items() if n}
    (c2, p2, t2), (c1, p1, t1) = out[False], out[True]
    err = float(np.abs(c1.astype(np.float64) - c2).max())
    diff = int((p1 != p2).sum())
    emit({"phase": "one_pass_posterior", "symbols": int(obs.size), "max_conf_err": err,
          "path_positions_differing": diff, "wall_s_two_pass": t2, "wall_s_one_pass": t1,
          "launches_two_pass": launches[False], "launches_one_pass": launches[True]})
    if (err > 2e-5 or launches[True].get("oh_fwdbwd_mat") != 1
            or launches[True].get("oh_prod") or launches[True].get("oh_fwdbwd")):
        raise SystemExit("chip_smoke: the one-pass posterior leaves the two-pass one")
    return launches[True]


def budget_lane_phase(big: np.ndarray, fa: str, dev) -> None:
    """Peak device bytes per symbol and device ms (CUDA events, one call) of
    one seq E-step at 16 Mi and 64 Mi symbols (reduced two-pass, one-pass,
    split, dense K = 8), the budget they give on this card, and one seq
    E-step of the genome at three lane lengths."""
    from cpgisland_tpu_torch.ops.prepared import prepare_seq as prep_seq
    from cpgisland_tpu_torch.train import backends as BE

    params = presets.durbin_cpg8(device=dev)
    worst = 0.0
    for n in (16 << 20, 64 << 20):
        obs = torch.from_numpy(big[:n]).to(dev)
        for label, engine, one_pass, fused in (("two_pass", "onehot", False, True),
                                               ("one_pass", "onehot", True, True),
                                               ("split", "onehot", False, False),
                                               ("dense_k8", "pallas", False, True)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            lane_T = fb_seq.pick_lane_T(n)
            prep = prep_seq(4, obs, n, lane_T=lane_T, onehot=engine == "onehot")
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            st = fb_seq.seq_stats(params, obs, n, lane_T=lane_T, engine=engine,
                                  prepared=prep, one_pass=one_pass, fused=fused)
            b.record()
            torch.cuda.synchronize()
            per = (torch.cuda.max_memory_allocated() - base) / n
            worst = max(worst, per)
            emit({"phase": "seq_memory", "symbols": n, "arm": label,
                  "peak_bytes_per_symbol": per, "estep_ms": a.elapsed_time(b),
                  "loglik": float(st.loglik)})
            del prep, st
    total = torch.cuda.get_device_properties(dev).total_memory
    emit({"phase": "seq_budget", "worst_bytes_per_symbol": worst,
          "constant_bytes_per_symbol": BE.SEQ_BYTES_PER_SYMBOL, "total_memory": total,
          "budget_symbols": BE.seq_shard_budget(dev),
          "budget_from_measured": (total - BE.SEQ_RESERVE_BYTES) // int(np.ceil(worst))})
    if worst > BE.SEQ_BYTES_PER_SYMBOL:
        raise SystemExit(f"chip_smoke: seq_stats peaks at {worst:.1f} B/symbol, above the "
                         f"budget's {BE.SEQ_BYTES_PER_SYMBOL}")

    chunked = chunking.frame(codec.encode_file(fa, skip_headers=True), chunking.TRAIN_CHUNK)
    times = {}
    for lane_T in (4096, 8192, 16384, 16384, 8192, 4096):
        backend = BE.SeqBackend(lane_T=lane_T)
        chunks, lengths = backend.place(backend.prepare(chunked), dev)
        prep = backend.prepare_streams(params, chunks, lengths)
        ms = time_ms(lambda: backend(params, chunks, lengths, prepared=prep), runs=5)
        times.setdefault(lane_T, []).append(ms)
    emit({"phase": "seq_lane_T", "symbols": chunked.total, "estep_ms": times})


# ---------------------------------------------------------------------------
# Phases 30-33: the split arm (fused=False): B9-B12, B22 and B23


def _bit_row(name, got, want, kernel_fn, plain_ms, n_bytes, n_ops, steps, **extra) -> dict:
    """kernel_row for a kernel that must equal its plain version bit for
    bit; fails the run otherwise."""
    equal = torch.equal(got, want)
    row = kernel_row(name, equal, max_abs_err(got, want), kernel_fn, plain_ms, n_bytes, n_ops,
                     steps, bit_equal=equal, **extra)
    if not equal:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version "
                         f"({extra.get('geometry', 'train')})")
    return row


def split_fwd_checks(args, b4_args, stacked: bool) -> dict:
    """B9 (B22 with ``stacked``) on ``args`` beside its row's check at the
    default G: equal to B4's (B24's) alphas at the same G; in one sub-lane
    bit-equal to its plain version (timed) and to B4's alphas in one
    sub-lane.  Fails the run otherwise."""
    kern = FB.oh_fwd_stacked if stacked else FB.oh_fwd
    plain = FB.oh_fwd_stacked_plain if stacked else FB.oh_fwd_plain
    b4 = FB.oh_fwdbwd_stacked if stacked else FB.oh_fwdbwd
    Tp = args[0].shape[0]
    al = kern(*args)
    equals_b4 = torch.equal(b4(*b4_args)[0], al)
    del al
    with sublane_length(Tp):
        al1 = kern(*args)
        al_p, g1_plain_ms = timed_once(lambda: plain(*args))
        g1_equal = torch.equal(al1, al_p)
        del al_p
        g1_equals_b4 = torch.equal(b4(*b4_args)[0], al1)
        g1_ms = time_ms(lambda: kern(*args), runs=10)
    del al1
    out = {"sublanes": FB.sublanes(Tp), "equals_b4_alphas": equals_b4,
           "g1_bit_equal": g1_equal, "g1_plain_ms": g1_plain_ms,
           "g1_ms": g1_ms, "g1_equals_b4_alphas": g1_equals_b4}
    if not (equals_b4 and g1_equal and g1_equals_b4):
        raise SystemExit(f"chip_smoke: {'oh_fwd_stacked' if stacked else 'oh_fwd'} at "
                         f"{tuple(args[0].shape)} fails a check: {out}")
    return out


def split_bwd_checks(args, stacked: bool) -> dict:
    """B10 (B23 with ``stacked``) on ``args`` beside its row's check at the
    default G: in one sub-lane bit-equal to its plain version (timed) and,
    for B10, at each SWEEP_SPLIT_BWD_SUBLANE_T (timed, with its largest
    relative difference from G = 1).  Fails the run otherwise."""
    kern = FB.oh_bwd_stacked if stacked else FB.oh_bwd
    plain = FB.oh_bwd_stacked_plain if stacked else FB.oh_bwd_plain
    Tp = args[0].shape[0]
    with bwd_sublane_length(Tp):
        be1 = kern(*args)
        be_p, g1_plain_ms = timed_once(lambda: plain(*args))
        g1_equal = torch.equal(be1, be_p)
        del be_p
        g1_ms = time_ms(lambda: kern(*args), runs=10)
    sweep = {}
    for st in () if stacked else SWEEP_SPLIT_BWD_SUBLANE_T:
        with bwd_sublane_length(st):
            be = kern(*args)
            sweep[str(st)] = {"G": FB.split_bwd_sublanes(Tp),
                              "ms": time_ms(lambda: kern(*args), runs=10),
                              "max_rel_vs_g1": max_rel_diff(be, be1)}
            del be
    del be1
    out = {"sublanes": FB.split_bwd_sublanes(Tp), "g1_bit_equal": g1_equal,
           "g1_plain_ms": g1_plain_ms, "g1_ms": g1_ms, "sweep": sweep}
    if not g1_equal:
        raise SystemExit(f"chip_smoke: {'oh_bwd_stacked' if stacked else 'oh_bwd'} in one "
                         f"sub-lane disagrees with its plain version at {tuple(args[0].shape)}")
    return out


def split_stacked_rows(rng, gen, S: int, M: int, pair2, pairn2, lens2, T: int, geo: str,
                       dev) -> tuple:
    """B22 and B23 for M members at one geometry: against their plain
    versions at M in PLAIN_STACK_M (at the default G, and in one sub-lane
    by split_fwd_checks / split_bwd_checks), per member against B9 / B10 at
    every M, timed beside M x the single-model kernel.  Returns their rows."""
    Tp, NL = pair2.shape
    n = Tp * NL
    members = family_members(gen, dev, S, M)
    _, tabs = FB.stacked_tables(members)
    one = lambda m: tabs[m].contiguous()  # noqa: E731
    rand = lambda: torch.from_numpy(  # noqa: E731
        rng.random((M, 2, NL)).astype(np.float32) + 0.01).to(dev)
    a0s, b0s = rand(), rand()
    tab_b = tabs[0].numel() * 4
    f_args = (pair2, lens2, a0s, tabs)
    plain = M in PLAIN_STACK_M
    al = FB.oh_fwd_stacked(*f_args)
    al_p, plain_ms = plain_once(plain, lambda: [FB.oh_fwd_stacked_plain(*f_args)])
    per = all(torch.equal(FB.oh_fwd(pair2, lens2, a0s[m], one(m)), al[m]) for m in range(M))
    single_ms = time_ms(lambda: FB.oh_fwd(pair2, lens2, a0s[0], one(0)), runs=10)
    more = split_fwd_checks(f_args, (pair2, pairn2, lens2, a0s, b0s, tabs, T), True) if plain \
        else {}
    f_row = _stacked_row(
        "oh_fwd_stacked", S, M, geo, [al], al_p, per,
        lambda: FB.oh_fwd_stacked(*f_args), plain_ms, single_ms,
        # the shared pairs read once, M x the alphas written
        4 * n + M * (8 * n + 8 * NL + tab_b) + 4 * NL, M * 10 * n, n, **more)
    del al_p
    cs = FB.cs_next_of(al)
    b_args = (pairn2, lens2, cs, b0s, tabs, T)
    be = FB.oh_bwd_stacked(*b_args)
    be_p, plain_ms = plain_once(plain, lambda: [FB.oh_bwd_stacked_plain(*b_args)])
    per = all(torch.equal(FB.oh_bwd(pairn2, lens2, cs[m], b0s[m], one(m), T), be[m])
              for m in range(M))
    single_ms = time_ms(lambda: FB.oh_bwd(pairn2, lens2, cs[0], b0s[0], one(0), T), runs=10)
    more = split_bwd_checks(b_args, True) if plain else {}
    b_row = _stacked_row(
        "oh_bwd_stacked", S, M, geo, [be], be_p, per,
        lambda: FB.oh_bwd_stacked(*b_args), plain_ms, single_ms,
        # the shared pairn once, M x (cs_next read, the betas written)
        4 * n + M * (12 * n + 8 * NL + tab_b) + 4 * NL, M * 9 * n, n, **more)
    del al, be, be_p, cs
    return f_row, b_row


def split_stats_row(st_args, valid: int, **extra) -> dict:
    """B12 on ``st_args`` held within rtol 1e-5 / atol 1e-3 of its plain
    version, two launches bit-equal, timed beside its bound; raises on a
    disagreement."""
    Tp, _, NL = st_args[0].shape
    S = st_args[5].shape[0]
    K = 2 * S
    got, again = FB.oh_stats(*st_args), FB.oh_stats(*st_args)
    want, plain_ms = timed_once(lambda: FB.oh_stats_plain(*st_args))
    agree = all(torch.allclose(g, w, rtol=1e-5, atol=1e-3) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, again))
    del want, got, again
    row = kernel_row(
        "oh_stats", agree, err, lambda: FB.oh_stats(*st_args), plain_ms,
        # B12 reads valid steps only
        n_bytes=20 * valid + 4 * NL + (K * K + 2 * S + 1) * NL * 4,
        n_ops=26 * valid, steps=valid, tolerance="rtol 1e-5, atol 1e-3",
        segment_t=FB.stats_segment_t(Tp, NL), segments_per_block=FB.stats_segments_per_block(S),
        two_launches_equal=equal, **extra)
    if not (agree and equal):
        raise SystemExit(f"chip_smoke: oh_stats disagrees with its plain version or between "
                         f"two launches ({extra})")
    return row


def split_stats_genome_row(params, dev) -> None:
    """B12's row at the genome's own training batch (GENOME_CHUNKS ragged
    chunks of FB_TP steps) on B9's and B10's streams, as
    :func:`seq_stats_main_shapes` gives B5's; a generator of its own."""
    own = np.random.default_rng(6)
    S = params.n_symbols
    gt = OH._groups(params)
    tab = FB.prob_tab_ext(params, gt)
    chunks, lengths = ragged_chunks(own, S, GENOME_CHUNKS)
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                           torch.from_numpy(lengths).to(dev), t_tile=fb_chunked.DEFAULT_T_TILE)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    al = FB.oh_fwd(prep.pair2, prep.lens2, a0, tab)
    be = FB.oh_bwd(prep.pairn2, prep.lens2, FB.cs_next_of(al), b0, tab, FB_TP)
    split_stats_row((al, be, prep.pair2, prep.lens2, FB.reduced_emissions(params, gt),
                     gt.to(torch.int32).contiguous()), int(np.minimum(lengths, FB_TP).sum()),
                    geometry=f"train, {GENOME_CHUNKS} chunks")
    del al, be, prep, chunks
    torch.cuda.empty_cache()


def split_kernel_phase(rng: np.random.Generator, gen: torch.Generator, params, big: np.ndarray,
                       dev) -> dict:
    """The split arm's kernels at the main paths' shapes: B9, B10 and B12 at
    the training geometry (FB_NL x FB_TP, ragged as B4 / B5), B22 and B23
    there for M in SPLIT_STACK_M, and B9, B10, B11, B22 and B23 (M = 2) at
    8192 x 8192 on the genome's 64 Mi record.  B9-B11 bit-equal to their
    plain versions, B22 and B23 too at M = 2, B9-B11 (B22 and B23 at M =
    2) at their default sub-lanes and in one sub-lane; B9 also to B4's
    alphas at both, B11 to the confidence over B10's betas at both; B10's
    sub-lane sweep; B22 and B23 per member to B9 and B10 at every M; B12
    within rtol 1e-5 / atol 1e-3, two launches bit-equal, also at the
    genome's GENOME_CHUNKS chunks.  Returns the table rows: the training
    geometry's (stacked: M = 2), B11 at the posterior's."""
    K, S = params.n_states, params.n_symbols
    gt = OH._groups(params)
    tab = FB.prob_tab_ext(params, gt)
    tab_b = tab.numel() * 4
    results = {}

    chunks, lengths = ragged_chunks(rng, S)
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                           torch.from_numpy(lengths).to(dev), t_tile=fb_chunked.DEFAULT_T_TILE)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    Tp, NL = prep.pair2.shape
    n = Tp * NL
    f_args = (prep.pair2, prep.lens2, a0, tab)
    al = FB.oh_fwd(*f_args)
    al_p, plain_ms = timed_once(lambda: FB.oh_fwd_plain(*f_args))
    more = split_fwd_checks(f_args, (prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, FB_TP),
                            False)
    results["oh_fwd"] = _bit_row(
        "oh_fwd", al, al_p, lambda: FB.oh_fwd(*f_args), plain_ms,
        # the pairs read, the alphas written; per step 4 multiplies, 3 adds,
        # a division and 2 scaling multiplies
        4 * n + 8 * n + 4 * NL + 8 * NL + tab_b, 10 * n, n, **more)
    del al_p
    cs_next = FB.cs_next_of(al)
    b_args = (prep.pairn2, prep.lens2, cs_next, b0, tab, FB_TP)
    be = FB.oh_bwd(*b_args)
    be_p, plain_ms = timed_once(lambda: FB.oh_bwd_plain(*b_args))
    results["oh_bwd"] = _bit_row(
        "oh_bwd", be, be_p, lambda: FB.oh_bwd(*b_args), plain_ms,
        # pairn + cs_next read, the betas written; per step 6 multiplies, 2
        # adds and a division
        8 * n + 8 * n + 4 * NL + 8 * NL + tab_b, 9 * n, n, **split_bwd_checks(b_args, False))
    del be_p
    assert not torch.backends.cuda.matmul.allow_tf32
    st_args = (al, be, prep.pair2, prep.lens2, FB.reduced_emissions(params, gt),
               gt.to(torch.int32).contiguous())
    results["oh_stats"] = split_stats_row(st_args, int(np.minimum(lengths, Tp).sum()),
                                          geometry="train")
    del al, be, cs_next, st_args
    split_stats_genome_row(params, dev)

    for M in SPLIT_STACK_M:
        f_row, b_row = split_stacked_rows(rng, gen, S, M, prep.pair2, prep.pairn2, prep.lens2,
                                          FB_TP, "train", dev)
        if M == 2:
            results |= {"oh_fwd_stacked": f_row, "oh_bwd_stacked": b_row}
    del prep
    torch.cuda.empty_cache()

    T = POST_NL * POST_LANE_T
    post = prepare_seq(S, torch.from_numpy(big[:T]).to(dev), T, lane_T=POST_LANE_T)
    lens2 = post.lane_lens[None, :].contiguous()
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((2, POST_NL)).astype(np.float32) + 0.01).to(dev)
    a0, b0 = v(), v()
    geo = "genome 64 Mi record, 8192 x 8192"
    f_args = (post.pair2, lens2, a0, tab)
    al = FB.oh_fwd(*f_args)
    al_p, plain_ms = timed_once(lambda: FB.oh_fwd_plain(*f_args))
    more = split_fwd_checks(f_args, (post.pair2, post.pairn2, lens2, a0, b0, tab, POST_LANE_T),
                            False)
    _bit_row("oh_fwd", al, al_p, lambda: FB.oh_fwd(*f_args), plain_ms,
             12 * T + 12 * POST_NL + tab_b, 10 * T, T, geometry=geo, **more)
    del al_p
    cs_next = FB.cs_next_of(al)
    b_args = (post.pairn2, lens2, cs_next, b0, tab, POST_LANE_T)
    be = FB.oh_bwd(*b_args)
    be_p, plain_ms = timed_once(lambda: FB.oh_bwd_plain(*b_args))
    _bit_row("oh_bwd", be, be_p, lambda: FB.oh_bwd(*b_args), plain_ms,
             16 * T + 12 * POST_NL + tab_b, 9 * T, T, geometry=geo,
             **split_bwd_checks(b_args, False))
    mask = torch.zeros(K, dtype=torch.float32, device=dev)
    mask[list(ISLAND_STATES)] = 1.0
    mtab = mask[gt].contiguous()
    c_args = (post.pairn2, post.pair2, lens2, cs_next, b0, al, mtab, tab, POST_LANE_T)
    conf = FB.oh_bwd_conf(*c_args)
    conf_p, plain_ms = timed_once(lambda: FB.oh_bwd_conf_plain(*c_args))
    esym = FB.decode_esym(post.pair2, S)
    more = {"sublanes": FB.split_bwd_sublanes(POST_LANE_T),
            "equals_conf_of_b10": torch.equal(conf, FB._conf_from_mtab(al, be, esym, lens2,
                                                                        mtab))}
    del be, be_p
    with bwd_sublane_length(POST_LANE_T):
        conf1 = FB.oh_bwd_conf(*c_args)
        conf1_p, more["g1_plain_ms"] = timed_once(lambda: FB.oh_bwd_conf_plain(*c_args))
        more["g1_bit_equal"] = torch.equal(conf1, conf1_p)
        more["g1_equals_conf_of_b10"] = torch.equal(conf1, FB._conf_from_mtab(
            al, FB.oh_bwd(*b_args), esym, lens2, mtab))
        more["g1_ms"] = time_ms(lambda: FB.oh_bwd_conf(*c_args), runs=10)
    del conf1, conf1_p
    if not all(more[k] for k in ("equals_conf_of_b10", "g1_bit_equal", "g1_equals_conf_of_b10")):
        raise SystemExit(f"chip_smoke: oh_bwd_conf fails a check: {more}")
    results["oh_bwd_conf"] = _bit_row(
        "oh_bwd_conf", conf, conf_p, lambda: FB.oh_bwd_conf(*c_args), plain_ms,
        # pairn, pairs, cs_next and alphas read, the confidence written; per
        # step B10's 9 operations and the confidence's 8
        20 * T + 4 * T + 12 * POST_NL + tab_b + 8 * S, 17 * T, T, geometry=geo, **more)
    del al, cs_next, conf, conf_p, esym
    split_stacked_rows(rng, gen, S, PLAIN_STACK_M[0], post.pair2, post.pairn2, lens2,
                       POST_LANE_T, geo, dev)
    del post
    torch.cuda.empty_cache()
    return results


def split_train_phase(params, fa: str, dev, fused_logliks: dict) -> dict:
    """train_file through LocalBackend(fuse_fb=False), compat then clean:
    B9, B10 and B12 exactly TRAIN_ITERS each per mode, B4 and B5 never, and
    each loglik within SPLIT_LL_RTOL of phase 4's fused run.  Returns the
    launch counts."""
    launches, logliks = train_phase(params, fa, dev, kernels=SPLIT_TRAIN_KERNELS,
                                    absent=TRAIN_KERNELS + DENSE_TRAIN_KERNELS,
                                    backend=LocalBackend(fuse_fb=False), model="durbin8 split")
    rel = max(float(np.max(np.abs(np.subtract(logliks[m], fused_logliks[m]))
                           / np.abs(fused_logliks[m]))) for m in logliks)
    emit({"phase": "split_vs_fused_train", "max_ll_rel": rel})
    if rel > SPLIT_LL_RTOL:
        raise SystemExit("chip_smoke: the split chunked trajectory leaves the fused one")
    return launches


def _posterior_runs(label, fn, arms, checks) -> dict:
    """Run ``fn(fused)`` for each arm of ``arms`` (fused, split, split,
    fused: the turns a comparison takes), counting launches and wall; the
    split arm's launches must equal ``checks``.  Returns {fused: (conf,
    path, walls, launches)}."""
    out = {}
    for fused in arms:
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conf, path = fn(fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _kernels.launches.items() if v}
        prev = out.setdefault(fused, (conf, path, [], counts))
        prev[2].append(wall)
    c_f, p_f, t_f, n_f = out[True]
    c_s, p_s, t_s, n_s = out[False]
    to_np = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x  # noqa: E731
    err = float(np.abs(to_np(c_s).astype(np.float64) - to_np(c_f)).max())
    paths_equal = p_f is None or bool(np.array_equal(to_np(p_s), to_np(p_f)))
    emit({"phase": "split_posterior", "run": label, "max_conf_err": err,
          "paths_equal": paths_equal, "wall_s_fused": t_f, "wall_s_split": t_s,
          "launches_fused": n_f, "launches_split": n_s})
    if err > SPLIT_CONF_ATOL or not paths_equal or n_s != checks:
        raise SystemExit(f"chip_smoke: the split posterior ({label}) leaves the fused one or "
                         f"launched {n_s}, not {checks}")
    return out


def split_posterior_phase(params, big: np.ndarray, dev) -> dict:
    """posterior_sharded(fused=False) on the 64 Mi record (B7, B9 and B11;
    with the path B7, B9 and B10), a continuation span of 16 Mi with
    threaded directions and prev_sym, and fb_seq.batch_posterior over 256
    small records one per lane (B9 and B11, or B9 and B10): exact launch
    counts, confidence within SPLIT_CONF_ATOL of the fused arm, MPM paths
    equal; the one-span posterior timed on the card both ways.  Returns
    the split runs' launch counts."""
    from cpgisland_tpu_torch.parallel.posterior import place_record_span

    S, K = params.n_symbols, params.n_states
    arms = (True, False, False, True)
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    T = POST_NL * POST_LANE_T
    obs = big[:T]
    placed = place_record_span(params, obs)
    for want_path in (False, True):
        want = {"oh_prod": 1, "oh_fwd": 1, ("oh_bwd" if want_path else "oh_bwd_conf"): 1}
        out = _posterior_runs(
            f"64 Mi record, path={want_path}",
            lambda fused: posterior_sharded(params, obs, ISLAND_STATES, want_path=want_path,
                                            placed=placed, fused=fused),
            arms, want)
        add(out[False][3])
    mask = np.zeros(K, np.float32)
    mask[list(ISLAND_STATES)] = 1.0
    ms = {fused: time_ms(lambda: fb_seq.seq_posterior(params, placed, T, mask,
                                                      lane_T=POST_LANE_T, fused=fused), runs=5)
          for fused in arms}
    emit({"phase": "split_posterior_device_ms", "symbols": T, "fused_ms": ms[True],
          "split_ms": ms[False], "split_minus_fused_ms": ms[False] - ms[True]})
    del placed

    span = T // 4  # 16 Mi: the second of the record's four spans at a 16 Mi span
    piece = big[span : 2 * span]
    prev = int(big[span - 1])
    rng = np.random.default_rng(int(piece[:64].sum()))
    enter = np.zeros(K, np.float32)
    enter[[prev, prev + S]] = rng.random(2) + 0.1
    last = int(piece[-1])
    exit_ = np.zeros(K, np.float32)
    exit_[[last, last + S]] = rng.random(2) + 0.1
    out = _posterior_runs(
        "16 Mi continuation span",
        lambda fused: posterior_sharded(params, piece, ISLAND_STATES, want_path=True,
                                        first=False, enter_dir=enter, exit_dir=exit_,
                                        prev_sym=prev, fused=fused),
        arms, {"oh_prod": 1, "oh_fwd": 1, "oh_bwd": 1})
    add(out[False][3])

    N, Tb = N_SCAFFOLDS, 1 << 16
    starts = rng.integers(0, big.size - Tb, size=N)
    lengths = rng.integers(2 << 10, Tb + 1, size=N).astype(np.int32)
    chunks = np.stack([big[a : a + Tb] for a in starts])
    chunks[np.arange(Tb)[None, :] >= lengths[:, None]] = S
    ch, ln = torch.from_numpy(chunks).to(dev), torch.from_numpy(lengths).to(dev)
    for want_path in (False, True):
        out = _posterior_runs(
            f"batch of {N} records, path={want_path}",
            lambda fused: fb_seq.batch_posterior(params, ch, ln, mask, want_path=want_path,
                                                 fused=fused),
            arms, {"oh_fwd": 1, ("oh_bwd" if want_path else "oh_bwd_conf"): 1})
        add(out[False][3])
    return launches


def split_family_phase(gen: torch.Generator, fa: str, big: np.ndarray, dev) -> dict:
    """fit_family with FamilyEStep(fuse_fb=False), FAMILY_M members on the
    genome's training batch, TRAIN_ITERS iterations: one B22, one B23 and
    FAMILY_M launches of B12 an iteration, no fused or single-model chain;
    logliks within SPLIT_LL_RTOL of the fused fit_family; the stacked split
    E-step equal to the sequential one bit for bit; then
    posterior_sharded_stacked(fused=False) of two members on the 64 Mi
    record (B21, B22 and B23 once each) equal to their own
    posterior_sharded(fused=False) runs bit for bit, with the path and
    without, and within SPLIT_CONF_ATOL of the fused stacked run; the
    stacked posterior's device time on both arms, and on the split arm with
    B22 and B23 in one chain (the kernels and glue before they took
    sub-lanes).  Returns the launch counts."""
    from cpgisland_tpu_torch.parallel.posterior import island_mask, place_record_span, \
        posterior_sharded_stacked

    chunked = chunking.frame(codec.encode_file(fa), chunking.TRAIN_CHUNK, drop_remainder=True)
    members = family_members(gen, dev, 4, FAMILY_M)
    chunks, lengths = LocalBackend().place(chunked, dev)
    split = FamilyEStep(fuse_fb=False)
    fit_family(members, chunks, lengths, n_iter=1, estep=split)  # warm
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = fit_family(members, chunks, lengths, n_iter=TRAIN_ITERS, estep=split)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _kernels.launches.items() if v}
    _, hist_f = fit_family(members, chunks, lengths, n_iter=TRAIN_ITERS)
    rel = float(np.max(np.abs(hist - hist_f) / np.abs(hist_f)))
    prep = split.prepare_streams(members, chunks, lengths)
    st_stacked = split(members, chunks, lengths, prepared=prep)
    st_seq = FamilyEStep(fuse_fb=False, stacked=False)(members, chunks, lengths, prepared=prep)
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in zip(st_stacked, st_seq)
               for f in ("init", "trans", "emit", "loglik", "n_seqs"))
    symbols = int(chunked.total)
    emit({"phase": "split_fit_family", "M": FAMILY_M, "symbols": symbols,
          "iterations": TRAIN_ITERS, "wall_s": wall,
          "em_msym_per_s_times_m": symbols * TRAIN_ITERS * FAMILY_M / wall / 1e6,
          "max_ll_rel_vs_fused": rel, "stacked_equals_sequential": same, "launches": counts})
    want = {"oh_fwd_stacked": TRAIN_ITERS, "oh_bwd_stacked": TRAIN_ITERS,
            "oh_stats": FAMILY_M * TRAIN_ITERS}
    if counts != want or rel > SPLIT_LL_RTOL or not same:
        raise SystemExit(f"chip_smoke: the split fit_family launched {counts} (want {want}), "
                         f"left the fused one by {rel} or its arms differ ({same})")

    obs = big[: POST_NL * POST_LANE_T]
    pair = members[:2]
    states = [ISLAND_STATES, (0, 3, 6)]
    placed = place_record_span(pair[0], obs)
    runs = {}
    for fused in (True, False):
        _kernels.reset_launches()
        conf, _ = posterior_sharded_stacked(pair, obs, states, placed=placed, fused=fused)
        runs[fused] = (conf, {k: v for k, v in _kernels.launches.items() if v})
    conf_s, n_s = runs[False]
    solo = all(np.array_equal(conf_s[m], posterior_sharded(
        p, obs, states[m], engine="onehot", placed=placed, fused=False, want_path=wp)[0])
        for m, p in enumerate(pair) for wp in (False, True))
    err = float(np.abs(conf_s.astype(np.float64) - runs[True][0]).max())
    masks = [island_mask(p, st) for p, st in zip(pair, states)]
    T = int(obs.size)
    dev_ms = lambda fused: time_ms(lambda: fb_seq.seq_posterior_stacked(  # noqa: E731
        pair, placed, T, masks, lane_T=POST_LANE_T, fused=fused), runs=5)
    ms = {"fused": dev_ms(True), "split": dev_ms(False)}
    with sublane_length(POST_LANE_T), patched(FP, BWD_SUBLANES_FROM=POST_LANE_T + 1):
        ms["split_one_chain"] = dev_ms(False)
    emit({"phase": "split_posterior_stacked", "M": 2, "symbols": T,
          "equals_single_runs": solo, "max_conf_err_vs_fused": err, "launches": n_s,
          "device_ms": ms})
    want = {"oh_prod_stacked": 1, "oh_fwd_stacked": 1, "oh_bwd_stacked": 1}
    if not solo or err > SPLIT_CONF_ATOL or n_s != want:
        raise SystemExit(f"chip_smoke: the stacked split posterior differs from its single "
                         f"runs ({solo}), the fused arm ({err}) or launched {n_s}")
    for k, v in n_s.items():
        counts[k] = counts.get(k, 0) + v
    return counts


# ---------------------------------------------------------------------------
# Phases 34-35: the stacked decode (B26-B28) and the mixed-model flush unit


def scrambled(p, gen: torch.Generator):
    """p with its states renumbered at random: still one-hot in pairs, but
    each symbol's group (so each member's exit ids and exit anchors) lies
    elsewhere than in the flagship's layout."""
    perm = torch.randperm(p.n_states, generator=gen).to(p.device)
    return HmmParams(p.log_pi[perm], p.log_A[perm][:, perm], p.log_B[perm])


def decode_members(first, gen: torch.Generator, dev, M: int) -> list:
    """``first`` plus M - 1 scrambled random partition=2 members of its
    alphabet: a stacked decode's member set."""
    S = first.n_symbols
    return [first] + [scrambled(presets.random_hmm(gen, 2 * S, S, partition=2, device=dev), gen)
                      for _ in range(M - 1)]


def _decode_stream(rng: np.random.Generator, S: int, dev):
    """The B1-B3 geometry (BK x NB, 64 Mi steps) over a chaining stream of
    the S-symbol alphabet (consecutive steps of a lane chain), with PAD
    runs and sparse record resets: (steps [BK, NB] on the card, resets)."""
    steps = chaining_stream(rng, BK * NB, S).reshape(NB, BK).T.astype(np.int32)
    starts = rng.integers(0, BK, size=NB // 4)
    lanes = rng.integers(0, NB, size=NB // 4)
    lens = rng.integers(1, 200, size=NB // 4)
    for k0, b, n in zip(starts, lanes, lens):
        steps[k0 : k0 + n, b] = S
    resets = torch.from_numpy(rng.random((BK, NB)) < 1e-4).to(dev)
    return torch.from_numpy(np.ascontiguousarray(steps)).to(dev), resets


def stacked_decode_kernel_phase(rng: np.random.Generator, gen: torch.Generator, fa: str,
                                dev) -> dict:
    """B26, B27 (both arms) and B28 at the B1-B3 geometry for each of
    STACK_CONFIGS (the flagship or dinuc_cpg plus scrambled random members):
    bit-equal to their plain versions (one full-size run each, which also
    gives plain_ms) and per member to B1 / B2 / B6 / B3 on
    that member's operands, timed beside M x the single kernel's time and
    the byte bound.  At S = 16 (288-row tables, the repair) B1, B6 and B3
    are also held against their plain versions.  Then the reduced decode
    kernels at the flush's geometry (:func:`flush_geometry_timings`).
    Returns the table rows (S = 4, M = 2) by kernel name."""
    results = {}
    n = BK * NB
    for S in (4, 16):
        steps, resets = _decode_stream(rng, S, dev)
        prev0 = int(steps[0, 0].clamp_max(S - 1))
        for S_, M in STACK_CONFIGS:
            if S_ != S:
                continue
            first = presets.durbin_cpg8(device=dev) if S == 4 else presets.dinuc_cpg(device=dev)
            members = decode_members(first, gen, dev, M)
            _, _, tabs, idtabs, pair2, _, _, nreal = OH.stacked_prepared(
                members, steps, prev0, resets)
            assert nreal == S * S + S and pair2.shape == (BK, NB)
            tabs, idtabs = torch.stack(tabs), torch.stack(idtabs)
            nP = tabs.shape[1]
            v = rng.normal(scale=3.0, size=(M, 2, NB)).astype(np.float32)
            v_red = torch.from_numpy(v - v.max(axis=1, keepdims=True)).to(dev)
            bits = torch.from_numpy(rng.integers(0, 2, size=(M, NB)).astype(np.int32)).to(dev)
            one = lambda t, m: t[m].contiguous()  # noqa: E731

            red = OH.oh_products_stacked(pair2, tabs)
            bpw = OH.oh_backpointers_stacked(pair2, v_red, tabs)
            sc = OH.oh_backpointers_stacked_scores(pair2, v_red, tabs)
            path = OH.oh_backtrace_stacked(bpw[0], pair2, idtabs, bits)
            plain_ms = {}
            red_p, plain_ms["oh_products_stacked"] = timed_once(
                lambda: OH.oh_products_stacked_plain(pair2, tabs))
            bpw_p, plain_ms["oh_backpointers_stacked"] = timed_once(
                lambda: OH.oh_backpointers_stacked_plain(pair2, v_red, tabs))
            sc_p, plain_ms["oh_backpointers_stacked_scores"] = timed_once(
                lambda: OH.oh_backpointers_stacked_scores_plain(pair2, v_red, tabs))
            path_p, plain_ms["oh_backtrace_stacked"] = timed_once(
                lambda: OH.oh_backtrace_stacked_plain(bpw_p[0], pair2, idtabs, bits))
            singles = {  # stacked name -> (single kernel's call on member m, stacked outputs)
                "oh_products_stacked": (lambda m: (OH.oh_products(pair2, one(tabs, m)),),
                                        (red,)),
                "oh_backpointers_stacked": (lambda m: OH.oh_backpointers(
                    pair2, one(v_red, m), one(tabs, m)), bpw),
                "oh_backpointers_stacked_scores": (lambda m: OH.oh_backpointers_scores(
                    pair2, one(v_red, m), one(tabs, m)), sc),
                "oh_backtrace_stacked": (lambda m: (OH.oh_backtrace(
                    one(bpw[0], m), pair2, one(idtabs, m), one(bits, m)),), (path,)),
            }
            got = {"oh_products_stacked": [red], "oh_backpointers_stacked": list(bpw),
                   "oh_backpointers_stacked_scores": list(sc), "oh_backtrace_stacked": [path]}
            want = {"oh_products_stacked": [red_p], "oh_backpointers_stacked": list(bpw_p),
                    "oh_backpointers_stacked_scores": list(sc_p),
                    "oh_backtrace_stacked": [path_p]}
            calls = {
                "oh_products_stacked": lambda: OH.oh_products_stacked(pair2, tabs),
                "oh_backpointers_stacked": lambda: OH.oh_backpointers_stacked(pair2, v_red, tabs),
                "oh_backpointers_stacked_scores": lambda: OH.oh_backpointers_stacked_scores(
                    pair2, v_red, tabs),
                "oh_backtrace_stacked": lambda: OH.oh_backtrace_stacked(bpw[0], pair2, idtabs,
                                                                        bits),
            }
            tab_b, id_b = tabs[0].numel() * 4, idtabs[0].numel() * 4
            # The shared pair stream read once; per member its table, its
            # entering vectors and bits, and its outputs.
            bytes_moved = {
                "oh_products_stacked": 4 * n + M * (tab_b + 16 * NB),
                "oh_backpointers_stacked": 4 * n + M * (8 * NB + tab_b + n // 2 + 12 * NB),
                "oh_backpointers_stacked_scores": (4 * n + M * (8 * NB + tab_b + n // 2
                                                                + 12 * NB + 4 * n)),
                "oh_backtrace_stacked": 4 * n + M * (n // 2 + id_b + 4 * NB + 4 * n),
            }
            ops = {"oh_products_stacked": M * 12 * n, "oh_backpointers_stacked": M * 14 * n,
                   "oh_backpointers_stacked_scores": M * 15 * n,
                   "oh_backtrace_stacked": M * 3 * n}
            for name, (single, outs) in singles.items():
                per = all(all(torch.equal(a, b[m]) for a, b in zip(single(m), outs))
                          for m in range(M))
                single_ms = time_ms(lambda: single(0), runs=10)
                row = _stacked_row(name, S, M, "decode block", got[name], want[name], per,
                                   calls[name], plain_ms[name], single_ms, bytes_moved[name],
                                   ops[name], n, nP=nP)
                if (S, M) == (4, 2):
                    results[name] = row
            del red, bpw, sc, path, red_p, bpw_p, sc_p, path_p, got, want
            if S == 16:
                # The repair: the single-model kernels on a 288-row table.
                tab0, id0, v0, b0 = one(tabs, 0), one(idtabs, 0), one(v_red, 0), one(bits, 0)
                k1, (p1, ms1) = OH.oh_products(pair2, tab0), timed_once(
                    lambda: OH.oh_products_plain(pair2, tab0))
                k6, (p6, ms6) = OH.oh_backpointers_scores(pair2, v0, tab0), timed_once(
                    lambda: OH.oh_backpointers_scores_plain(pair2, v0, tab0))
                k3, (p3, ms3) = OH.oh_backtrace(k6[0], pair2, id0, b0), timed_once(
                    lambda: OH.oh_backtrace_plain(p6[0], pair2, id0, b0))
                eq = {"oh_products": torch.equal(k1, p1),
                      "oh_backpointers_scores": all(torch.equal(a, b) for a, b in zip(k6, p6)),
                      "oh_backtrace": torch.equal(k3, p3)}
                emit({"phase": "decode_s16", "nP": nP, "bit_equal": eq,
                      "ms": {"oh_products": time_ms(lambda: OH.oh_products(pair2, tab0), 10),
                             "oh_backpointers_scores": time_ms(
                                 lambda: OH.oh_backpointers_scores(pair2, v0, tab0), 10),
                             "oh_backtrace": time_ms(
                                 lambda: OH.oh_backtrace(k6[0], pair2, id0, b0), 10)},
                      "plain_ms": {"oh_products": ms1, "oh_backpointers_scores": ms6,
                                   "oh_backtrace": ms3}})
                if not all(eq.values()):
                    raise SystemExit(f"chip_smoke: B1 / B6 / B3 at S = 16 disagree with their "
                                     f"plain versions: {eq}")
                del k1, p1, k6, p6, k3, p3
            del tabs, idtabs, pair2, v_red, bits
            torch.cuda.empty_cache()
        del steps, resets
        torch.cuda.empty_cache()
    flush_geometry_timings(fa, dev)
    return results


def direct_ms(name: str, tensors, runs: int = 10, **ints) -> float:
    """Median device time of kernel ``name``'s C entry called straight
    through ctypes on ``tensors`` and ``ints`` (no wrapper checks, no
    launch count): the wrapper's cost is the gap to its own time."""
    fn = _kernels.library()[name]
    args = ([t.data_ptr() for t in tensors] + [int(ints[k]) for k in _kernels._SIGNATURES[name][2]]
            + [torch.cuda.current_stream().cuda_stream])

    def call():
        if fn(*args):
            raise SystemExit(f"chip_smoke: {name}'s C entry failed")
    return time_ms(call, runs)


def flush_geometry_timings(fa: str, dev) -> None:
    """The reduced decode kernels on the operands the largest of phase
    35's flushes hands them: its FLUSH_RECORDS scaffolds padded by
    ``pipeline._pad_small_batch`` and decoded by
    ``decode_batch_flat_stacked`` (one flat reset stream of bk = 4096
    steps a lane), its members the flagship plus random partition=2 ones
    from a generator of their own.  B26, B27 (both arms) and B28 at M = 2
    and 3, B1, B2, B6 and B3 on member 0: each held bit for bit against
    its plain version on those operands (each plain version run once, for
    all members: its ``plain_ms``) and timed (CUDA events, median of 10)
    through its wrapper and through its C entry ("direct"); one line with
    the shape."""
    recs = [(name, s) for name, s in codec.iter_fasta_records(fa) if name != "chr1"]
    flushes = [recs[i : i + FLUSH_RECORDS] for i in range(0, len(recs), FLUSH_RECORDS)]
    batch = max(flushes, key=lambda b: pipeline._pad_small_batch(b)[0].size)
    rows, lengths = pipeline._pad_small_batch(batch)
    rows_d, len_d = torch.from_numpy(rows).to(dev), torch.from_numpy(lengths).to(dev)
    members = decode_members(presets.durbin_cpg8(device=dev), torch.Generator().manual_seed(7),
                             dev, max(FLUSH_M))
    ops = {name: _captured(lambda: OH.decode_batch_flat_stacked(members, rows_d, len_d), OH,
                           name)[1][0]
           for name in ("oh_products_stacked", "oh_backpointers_stacked", "oh_backtrace_stacked")}
    pair2, v_red, tabs = ops["oh_backpointers_stacked"]
    bp, _, idtabs, bits = ops["oh_backtrace_stacked"]
    bk, nb = pair2.shape
    nP = tabs.shape[1]
    row = {"phase": "decode_flush_geometry", "records": len(batch), "padded": list(rows.shape),
           "bk": bk, "nb": nb, "ms": {}, "direct_ms": {}, "plain_ms": {}, "bit_equal": {}}

    # Each plain version runs once, for all max(FLUSH_M) members: a member's
    # values do not depend on the others', so member 0's are B1 / B2 / B6 /
    # B3's reference and the first M members' the stacked kernels'.
    M_all = max(FLUSH_M)
    head = lambda t, M: t[:M].contiguous()  # noqa: E731
    v3, t3 = head(v_red, M_all), head(tabs, M_all)
    sc, row["plain_ms"]["oh_backpointers_stacked_scores"] = timed_once(
        lambda: OH.oh_backpointers_stacked_scores_plain(pair2, v3, t3))
    red, row["plain_ms"]["oh_products_stacked"] = timed_once(
        lambda: OH.oh_products_stacked_plain(pair2, t3))
    bt_args = tuple(head(x, M_all) for x in (bp, idtabs, bits))
    path, row["plain_ms"]["oh_backtrace_stacked"] = timed_once(
        lambda: OH.oh_backtrace_stacked_plain(bt_args[0], pair2, *bt_args[1:]))

    def check(key, name, args, want, stacked_M=None):
        got = getattr(OH, name)(*args)
        got = got if isinstance(got, tuple) else (got,)
        row["bit_equal"][key] = all(torch.equal(a, b) for a, b in zip(got, want))
        row["ms"][key] = time_ms(lambda: getattr(OH, name)(*args), runs=10)
        ints = {"bk": bk, "nb": nb, "nP": nP} | ({"M": stacked_M} if stacked_M else {})
        if "backtrace" in name:
            ints["seg"] = OH.BT_SEG_WORDS
        row["direct_ms"][key] = direct_ms(name, [*args, *got], **ints)

    first = lambda t: t[0].contiguous()  # noqa: E731
    v0, t0 = first(v_red), first(tabs)
    check("oh_backpointers", "oh_backpointers", (pair2, v0, t0), [x[0] for x in sc[:3]])
    check("oh_backpointers_scores", "oh_backpointers_scores", (pair2, v0, t0), [x[0] for x in sc])
    check("oh_products", "oh_products", (pair2, t0), [red[0]])
    check("oh_backtrace", "oh_backtrace", (first(bp), pair2, first(idtabs), first(bits)),
          [path[0]])
    for M in FLUSH_M:
        v, t = head(v_red, M), head(tabs, M)
        check(f"oh_backpointers_stacked_m{M}", "oh_backpointers_stacked", (pair2, v, t),
              [x[:M] for x in sc[:3]], M)
        check(f"oh_backpointers_stacked_scores_m{M}", "oh_backpointers_stacked_scores",
              (pair2, v, t), [x[:M] for x in sc], M)
        check(f"oh_products_stacked_m{M}", "oh_products_stacked", (pair2, t), [red[:M]], M)
        check(f"oh_backtrace_stacked_m{M}", "oh_backtrace_stacked",
              (head(bp, M), pair2, head(idtabs, M), head(bits, M)), [path[:M]], M)
    emit(row)
    if not all(row["bit_equal"].values()):
        raise SystemExit(f"chip_smoke: the reduced decode kernels at the flush's geometry "
                         f"disagree with their plain versions: {row['bit_equal']}")


def stacked_flush_phase(params, fa: str, gen: torch.Generator, dev) -> dict:
    """``pipeline._decode_small_batch_stacked`` over the genome's 256
    scaffolds in decode_file's flushes of FLUSH_RECORDS, owners round-robin
    over M members (the flagship plus scrambled random partition=2
    members), for each M of FLUSH_M.  Device islands for every model: each flush launches B26,
    B27 and B28 once and B1-B3 never, and every member's flush paths equal
    its own ``decode_batch_flat`` of the same padded batch bit for bit.
    Island calls against the per-model sequential ``_decode_small_batch``
    flushes: a record whose calls differ has its two paths rescored in
    float64, and the scores must agree within 64 f32 ulps plus 5e-5 of the
    score (a tie under the flat decoder's rounding contract, not a fault).
    Wall of all flushes (stacked, sequential, sequential, stacked) and
    device busy time of the first PROFILED_FLUSHES, both arms, with the
    padded steps each arm walks.  Then host islands for one model (calls
    equal the device engine's) and the scores arm of
    ``decode_batch_flat_stacked`` over all scaffolds in one batch (B27's
    scores arm once; each member's paths and scores equal its own flat
    decode).  Returns the launch counts of those main-path runs."""
    recs = [(name, s) for name, s in codec.iter_fasta_records(fa) if name != "chr1"]
    starts = list(range(0, len(recs), FLUSH_RECORDS))
    flushes = [recs[i : i + FLUSH_RECORDS] for i in starts]
    totals: dict = {}
    for M in FLUSH_M:
        members = decode_members(params, gen, dev, M)
        owners = [[(base + i) % M for i in range(len(b))] for b, base in zip(flushes, starts)]
        caps = [[DEFAULT_CAP] for _ in range(M)]
        kw = dict(min_len=None, island_states_list=[None] * M, cap_boxes=caps, phases={})

        def stacked(use_dev, keep_paths=False, n=None):
            parts, paths = [], []
            for batch, own in zip(flushes[:n], owners[:n]):
                def unit(batch=batch, own=own):
                    return pipeline._decode_small_batch_stacked(
                        members, batch, own, use_device_list=use_dev, **kw)[1]
                if keep_paths:
                    p, (_, out) = _captured(unit, OH, "decode_batch_flat_stacked")
                    paths.append(out)
                else:
                    p = unit()
                parts.extend(p)
            return parts, paths

        def sequential(n=None):
            parts = [None] * len(recs)
            for batch, own, base in zip(flushes[:n], owners[:n], starts[:n]):
                for m in range(M):
                    idx = [i for i in range(len(batch)) if own[i] == m]
                    if not idx:
                        continue
                    p, _ = pipeline._decode_small_batch(
                        members[m], [batch[i] for i in idx], engine="onehot", min_len=None,
                        island_states=None, use_device=True, cap_box=caps[m], phases={})
                    for i, c in zip(idx, p):
                        parts[base + i] = c
            return parts

        def walled(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        stacked([True] * M, n=1)  # warm
        sequential(n=1)
        _kernels.reset_launches()
        (parts_s, paths_s), wall_s1 = walled(lambda: stacked([True] * M, keep_paths=True))
        counts = dict(_kernels.launches)
        parts_q, wall_q1 = walled(sequential)
        wall_q2 = walled(sequential)[1]
        wall_s2 = walled(lambda: stacked([True] * M))[1]
        # Device busy time over the first PROFILED_FLUSHES flushes (the
        # profiler's post-processing grows with the events traced).
        busy_s = profiled(f"stacked flushes 1-{PROFILED_FLUSHES}, M = {M}",
                          lambda: stacked([True] * M, n=PROFILED_FLUSHES))
        busy_q = profiled(f"sequential flushes 1-{PROFILED_FLUSHES}, M = {M}",
                          lambda: sequential(n=PROFILED_FLUSHES))

        # Every member's flush paths against its own flat decode of the
        # same padded batch.
        paths_equal = True
        gaps, differ = [], 0
        for f, (batch, own, base) in enumerate(zip(flushes, owners, starts)):
            rows, lengths = pipeline._pad_small_batch(batch)
            rows_d, len_d = torch.from_numpy(rows).to(dev), torch.from_numpy(lengths).to(dev)
            for m in range(M):
                paths_equal &= torch.equal(OH.decode_batch_flat(members[m], rows_d, len_d),
                                           paths_s[f][m])
            for m in range(M):
                idx = [i for i in range(len(batch)) if own[i] == m]
                seq_paths = None
                for k, i in enumerate(idx):
                    r = base + i
                    if parts_s[r].format_lines() == parts_q[r].format_lines():
                        continue
                    differ += 1
                    if seq_paths is None:  # the sequential flush's paths
                        srows, slens = pipeline._pad_small_batch([batch[j] for j in idx])
                        seq_paths = OH.decode_batch_flat(
                            members[m], torch.from_numpy(srows).to(dev),
                            torch.from_numpy(slens).to(dev)).cpu().numpy()
                    sym = batch[i][1]
                    a = path_score_f64(members[m], sym, paths_s[f][m][i, : sym.size].cpu().numpy())
                    b = path_score_f64(members[m], sym, seq_paths[k, : sym.size])
                    bound = 64 * float(np.spacing(np.float32(abs(a)))) + 5e-5 * abs(a)
                    gaps.append((abs(a - b), bound))
        del paths_s
        _kernels.reset_launches()
        parts_h, _ = stacked([True] + [False] * (M - 1))
        host_counts = dict(_kernels.launches)
        host_equal = all(a.format_lines() == b.format_lines() for a, b in zip(parts_s, parts_h))

        # The scores arm: every scaffold in one padded batch.
        rows, lengths = pipeline._pad_small_batch(recs)
        rows_d, len_d = torch.from_numpy(rows).to(dev), torch.from_numpy(lengths).to(dev)
        _kernels.reset_launches()
        (paths_b, scores_b), wall_b = walled(lambda: OH.decode_batch_flat_stacked(
            members, rows_d, len_d, return_score=True))
        score_counts = dict(_kernels.launches)
        scores_equal = True
        for m in range(M):
            own_p, own_sc = OH.decode_batch_flat(members[m], rows_d, len_d, return_score=True)
            scores_equal &= torch.equal(own_p, paths_b[m]) and torch.equal(own_sc, scores_b[m])
        finite = bool(torch.isfinite(scores_b).all())
        del paths_b, scores_b, rows_d, len_d
        torch.cuda.empty_cache()

        # Padded steps each arm's chains and island calls walk: the stacked
        # flush pads every model's rows to the flush's own row length.
        padded = {"stacked": 0, "sequential": 0}
        for batch, own in zip(flushes, owners):
            padded["stacked"] += M * pipeline._pad_small_batch(batch)[0].size
            for m in range(M):
                sub = [b for b, o in zip(batch, own) if o == m]
                padded["sequential"] += pipeline._pad_small_batch(sub)[0].size if sub else 0
        n_flush = len(flushes)
        path_arm = {"oh_products_stacked": n_flush, "oh_backpointers_stacked": n_flush,
                    "oh_backtrace_stacked": n_flush}
        # Each flush: B26, B27 and B28 once; nothing else of the decode.
        flush_ok = all({k: v for k, v in c.items() if v} == path_arm
                       for c in (counts, host_counts))
        score_ok = ({k: v for k, v in score_counts.items() if v}
                    == {"oh_products_stacked": 1, "oh_backpointers_stacked_scores": 1,
                        "oh_backtrace_stacked": 1})
        worst = max(gaps, key=lambda g: g[0] / g[1]) if gaps else (None, None)
        emit({"phase": "stacked_flush", "M": M, "flushes": n_flush, "records": len(recs),
              "symbols": int(sum(s.size for _, s in recs)), "padded_steps": padded,
              "launches": {k: v for k, v in counts.items() if v},
              "wall_s": {"stacked": [wall_s1, wall_s2], "sequential": [wall_q1, wall_q2]},
              f"device_busy_s_first_{PROFILED_FLUSHES}_flushes": {
                  "stacked": busy_s["device_busy_s"], "sequential": busy_q["device_busy_s"]},
              "paths_equal_own_flat_decode": paths_equal,
              "records_with_calls_differing_from_sequential": differ,
              "max_f64_gap": worst[0], "its_bound": worst[1],
              "host_islands_equal_device": host_equal,
              "host_run_launches": {k: v for k, v in host_counts.items() if v},
              "scores_arm": {"wall_s": wall_b, "launches": {k: v for k, v in score_counts.items()
                                                            if v},
                             "equal_own_flat_decode": scores_equal, "finite": finite}})
        if not (flush_ok and paths_equal and host_equal and score_ok and scores_equal
                and finite and all(g <= b for g, b in gaps)):
            raise SystemExit(f"chip_smoke: the stacked flush (M = {M}) is off: launches "
                             f"{flush_ok}, paths {paths_equal}, host islands {host_equal}, "
                             f"scores arm {score_ok} / {scores_equal} / {finite}, ties "
                             f"{[g for g in gaps if g[0] > g[1]]}")
        for src in (counts, host_counts, score_counts):
            for k in STACKED_DECODE_KERNELS:
                totals[k] = totals.get(k, 0) + src.get(k, 0)
    return totals


# ---------------------------------------------------------------------------
# Phase 36: the pair-composition bench (T1 = B9, T2-T4)

COMPOSE_MIB, COMPOSE_LANE_T = 64, 65536  # the bench's defaults: 1024 full lanes


def compose_phase(dev) -> tuple:
    """T2-T4 at the bench's geometry, on its inputs: bit-equal to their
    plain versions, T2 to B9 in one sub-lane (the chain they share) and T4
    to T3, T1-T4 within the bench's gate of the single-step plain reference
    (the sequential chain, B9's plain version in one sub-lane, as the bench
    gates); each kernel timed beside its bound,
    the whole variant (its streams built) beside it.  Then the bench's own
    entry point.  Returns (the table rows of T2-T4, the bench's launches)."""
    tab, tab_ext = BC.pair_tables(dev)
    pair2, lens2, a0 = BC.inputs(COMPOSE_MIB << 20, COMPOSE_LANE_T, dev)
    Tp, NL = pair2.shape
    n = Tp * NL
    fns = BC.variants(tab, tab_ext, lens2, a0)
    operands = {name: build(pair2) for name, (build, _) in fns.items()}
    got = {name: launch(operands[name]) for name, (_, launch) in fns.items()}
    # T2 shares B9's one chain: B9 in one sub-lane (its sub-lanes round
    # apart), whose plain version is the sequential chain the gate takes.
    with sublane_length(Tp):
        b9_g1 = FB.oh_fwd(pair2, lens2, a0, tab_ext)
        ref = FB.oh_fwd_plain(pair2, lens2, a0, tab_ext)
    mats, comp = operands["single-strm"], operands["composed"]
    idx, *tables = operands["composed-sel"]
    plains = {
        "single": timed_once(lambda: FB.oh_fwd_plain(pair2, lens2, a0, tab_ext)),
        "single-strm": timed_once(lambda: FC.oh_fwd_strm_plain(mats, lens2, a0)),
        "composed": timed_once(lambda: FC.oh_fwd_comp_plain(comp, lens2, a0)),
        "composed-sel": timed_once(lambda: FC.oh_fwd_compsel_plain(idx, lens2, a0, *tables)),
    }
    relations = {"t2_equals_b9": torch.equal(got["single-strm"], b9_g1),
                 "t4_equals_t3": torch.equal(got["composed-sel"], got["composed"]),
                 "t2_plain_equals_b9_plain": torch.equal(plains["single-strm"][0], ref)}
    del b9_g1
    rows, failed = {}, [k for k, ok in relations.items() if not ok]
    for name, (build, launch) in fns.items():
        kernel = BC.KERNEL_OF[name]
        want, plain_ms = plains[name]
        equal = torch.equal(got[name], want)
        gate = BC.gate_err(got[name], ref)
        n_bytes, n_ops = BC.traffic(name, Tp, NL)
        ops = operands[name]
        variant_ms = time_ms(lambda: launch(build(pair2)), runs=10)
        row = kernel_row(kernel, equal, max_abs_err(got[name], want), lambda: launch(ops),
                         plain_ms, n_bytes, n_ops, n, bit_equal=equal, variant=name,
                         geometry=f"bench, {NL} x {Tp}", gate_err=gate, variant_ms=variant_ms,
                         **(relations if name == "single" else {}))
        if name != "single":
            rows[kernel] = row
        if not equal or not gate < BC.GATE_TOL:
            failed.append(f"{kernel} (bit_equal {equal}, gate {gate:.2e})")
    if failed:
        raise SystemExit(f"chip_smoke: the compose variants fail: {failed}")
    del operands, got, ref, plains, mats, comp, idx, tables
    torch.cuda.empty_cache()

    # The bench's own entry point, its launches counted from 0.
    _kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = BC.main(["--mib", str(COMPOSE_MIB)])
    torch.cuda.synchronize()
    launches = {k: n for k, n in _kernels.launches.items() if n}
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit({"phase": "bench_compose", "rc": rc, "launches": launches, **line})
    ok = (rc == 0 and line["engine"] == "cuda" and set(line["variants"]) == set(BC.KERNEL_OF)
          and all(v["gate_err"] < BC.GATE_TOL for v in line["variants"].values())
          and launches == line["calls"] and set(launches) == set(BC.KERNEL_OF.values()))
    if not ok:
        raise SystemExit("chip_smoke: bench_compose failed its gate or launched other than "
                         "it reports")
    return rows, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = BC.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    emit({"phase": "card", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for rep in _kernels.build_info.get("nvcc_report", {}).values()
                    for ln in rep.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})
    emit({"phase": "ptxas_redesigned", "kernels": ptxas_of(REDESIGNED)})

    rng = np.random.default_rng(args.seed)
    params = presets.durbin_cpg8(device=dev)
    results = kernel_phase(rng, params, dev)
    results |= fb_kernel_phase(rng, params, dev)
    results |= post_kernel_phase(rng, params, dev)
    seq_stats_main_shapes(params, dev)
    results |= dense_kernel_phase(rng, dev)
    results |= dense_fb_kernel_phase(rng, dev)
    gen = torch.Generator().manual_seed(args.seed)
    results |= stacked_kernel_phase(rng, gen, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fa, big, launches = main_path_phase(rng, params, tmp, dev)
        launches |= dense_main_phase(fa, tmp, dev)
        island_engine_phase(fa, tmp, dev)
        dense_parity_phase(rng, big, tmp, dev)
        train_launches, onehot_logliks = train_phase(params, fa, dev)
        launches |= train_launches
        parity_phase(rng, params, big, tmp, dev)
        run_phase(fa, tmp, dev)
        # Launches on the main paths: each kernel's count over the decode,
        # train and posterior runs (the dense FB kernels: two_state's).
        for k, n in posterior_phase(params, fa, tmp, dev).items():
            launches[k] = launches.get(k, 0) + n
        posterior_parity_phase(rng, params, big, tmp, dev)
        profile_phase(params, big, fa, dev)
        dense_profile_phase(big, dev)
        dense_launches = dense_train_phase(params, fa, dev, onehot_logliks)
        for k, n in dense_posterior_phase(fa, tmp, dev).items():
            dense_launches[k] = dense_launches.get(k, 0) + n
        launches |= dense_launches
        dense_fb_parity_phase(rng, big, tmp, dev)
        dense_fb_profile_phase(big, fa, dev)
        results |= scoring_kernel_phase(big, dev)
        casts = compare_casts(gen, os.path.join(tmp, "run.model.txt"))
        # The compare runs and fit_family are main paths too: their counts
        # add to every kernel's.
        for counts in (compare_phase(compare_fasta(rng, tmp, big), tmp, dev, casts),
                       fit_family_phase(gen, fa, dev)):
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
        compare_parity_phase(rng, big, tmp, dev, casts)
        for k, n in scores_phase(params, fa, dev).items():
            launches[k] = launches.get(k, 0) + n
        genome_span_phase(fa, tmp, dev)
        for k, n in span_decode_phase(params, big, tmp, dev).items():
            launches[k] = launches.get(k, 0) + n
        # Whole-sequence EM, the device loop, the one-pass arm.
        results |= mat_kernel_phase(rng, params, big, dev)
        seq_launches, seq_results = seq_train_phase(fa, dev)
        for k, n in seq_launches.items():
            launches[k] = launches.get(k, 0) + n
        em_loop_phase(fa, dev, seq_results)
        seq_cpu_vs_card_phase(rng, tmp, dev)
        for k, n in one_pass_posterior_phase(params, big, dev).items():
            launches[k] = launches.get(k, 0) + n
        budget_lane_phase(big, fa, dev)
        # The split arm (fused=False): its kernels, then its main paths.
        results |= split_kernel_phase(rng, gen, params, big, dev)
        for counts in (split_train_phase(params, fa, dev, onehot_logliks),
                       split_posterior_phase(params, big, dev),
                       split_family_phase(gen, fa, big, dev)):
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
        # The stacked decode: its kernels, then the mixed-model flush unit.
        results |= stacked_decode_kernel_phase(rng, gen, fa, dev)
        for k, n in stacked_flush_phase(params, fa, gen, dev).items():
            launches[k] = launches.get(k, 0) + n
        # The pair-composition bench: its kernels, then its entry point.
        compose_rows, compose_launches = compose_phase(dev)
        results |= compose_rows
        for k, n in compose_launches.items():
            launches[k] = launches.get(k, 0) + n

    table = []
    for name, r in results.items():
        table.append({k: r[k] for k in (
            "name", "route", "source", "replaces")} | {"launches": launches[name]} | {
            k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")} | {k: r[k] for k in ("cuda_kernel",) if k in r})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
