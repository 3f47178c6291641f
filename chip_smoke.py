#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each one against its plain PyTorch version
on the card, drives the decode and the training main paths end to end (a
seeded chromosome-sized FASTA) and checks the results.  Phases, one JSON
line each:

1. card: name and power limit, kernel build time;
2. kernels: B1-B3 at full size (bk=4096, nb=16384: 64 Mi steps, PAD runs
   and record resets in the pair stream) and B4-B5 at NL=1024 lanes x
   Tp=65,536 steps (ragged lengths, a short last lane, PAD tails) — B1-B4
   bit-equal to their plain versions, B5 within rtol 1e-5 / atol 1e-3 —
   with median time, bound and plain-version time;
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
   of that run (all five kernels > 0);
7. profile: device time by kernel over one decode of the big record and
   over one EM iteration, and the device's idle share of each.

Then the kernel table as one JSON object and, last, the ok line.  Exits
non-zero on any failure, or when CUDA is not available.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cpgisland_tpu_torch import pipeline
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import load_text
from cpgisland_tpu_torch.ops import _kernels, fb_chunked
from cpgisland_tpu_torch.ops import fb_onehot as FB
from cpgisland_tpu_torch.ops import viterbi_onehot as OH
from cpgisland_tpu_torch.ops.prepared import prepare_chunked
from cpgisland_tpu_torch.parallel.decode import viterbi_sharded
from cpgisland_tpu_torch.train import baum_welch
from cpgisland_tpu_torch.train.backends import LocalBackend
from cpgisland_tpu_torch.utils import chunking, codec

BK, NB = 4096, 16384  # the default block; 64 Mi steps
FB_NL, FB_TP = 1024, chunking.TRAIN_CHUNK  # B4/B5: 1024 chunks of 65,536 steps
BIG_RECORD = 64 << 20
N_SCAFFOLDS = 256
PARITY_SYMBOLS = 4 << 20
TRAIN_ITERS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# name -> (the TPU kernel it replaces, its CUDA source)
KERNELS = {
    "oh_products": ("cpgisland_tpu/ops/viterbi_onehot.py:401",
                    "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backpointers": ("cpgisland_tpu/ops/viterbi_onehot.py:435",
                        "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_backtrace": ("cpgisland_tpu/ops/viterbi_onehot.py:539",
                     "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"),
    "oh_fwdbwd": ("cpgisland_tpu/ops/fb_onehot.py:266",
                  "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
    "oh_seq_stats": ("cpgisland_tpu/ops/fb_onehot.py:804",
                     "cpgisland_tpu_torch/csrc/fb_onehot.cu"),
}
DECODE_KERNELS = ("oh_products", "oh_backpointers", "oh_backtrace")
TRAIN_KERNELS = ("oh_fwdbwd", "oh_seq_stats")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    red_k = OH.oh_products(pair2, tab)
    red_p = OH.oh_products_plain(pair2, tab)
    bp_k, de_k, eb_k = OH.oh_backpointers(pair2, v_red, tab)
    bp_p, de_p, eb_p = OH.oh_backpointers_plain(pair2, v_red, tab)
    path_k = OH.oh_backtrace(bp_k, pair2, idtab, exit_bits)
    path_p = OH.oh_backtrace_plain(bp_p, pair2, idtab, exit_bits)
    checks = {
        "oh_products": [(red_k, red_p)],
        "oh_backpointers": [(bp_k, bp_p), (de_k, de_p), (eb_k, eb_p)],
        "oh_backtrace": [(path_k, path_p)],
    }
    tab_b, id_b = tab.numel() * 4, idtab.numel() * 4
    bytes_moved = {
        "oh_products": 4 * steps_n + tab_b + 16 * NB,
        "oh_backpointers": 4 * steps_n + 8 * NB + tab_b + steps_n // 2 + 8 * NB + 4 * NB,
        "oh_backtrace": steps_n // 2 + 4 * steps_n + id_b + 4 * NB + 4 * steps_n,
    }
    ops = {  # adds + maxes per step (compares and bit ops counted as ops)
        "oh_products": 12 * steps_n,
        "oh_backpointers": 14 * steps_n,
        "oh_backtrace": 3 * steps_n,
    }
    calls = {
        "oh_products": (lambda: OH.oh_products(pair2, tab),
                        lambda: OH.oh_products_plain(pair2, tab)),
        "oh_backpointers": (lambda: OH.oh_backpointers(pair2, v_red, tab),
                            lambda: OH.oh_backpointers_plain(pair2, v_red, tab)),
        "oh_backtrace": (lambda: OH.oh_backtrace(bp_k, pair2, idtab, exit_bits),
                         lambda: OH.oh_backtrace_plain(bp_k, pair2, idtab, exit_bits)),
    }
    for name, pairs in checks.items():
        equal = all(torch.equal(a, b) for a, b in pairs)
        err = max(max_abs_err(a, b) for a, b in pairs)
        kernel_fn, plain_fn = calls[name]
        results[name] = kernel_row(name, equal, err, kernel_fn, plain_fn, bytes_moved[name],
                                   ops[name], steps_n, plain_runs=3, bit_equal=equal)
        if not equal:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return results


def kernel_row(name, agree, err, kernel_fn, plain_fn, n_bytes, n_ops, steps, plain_runs,
               **extra) -> dict:
    """Time a kernel (median of 10) and its plain version, add the bound,
    print the row and return it."""
    ms = time_ms(kernel_fn, runs=10)
    plain_ms = time_ms(plain_fn, runs=plain_runs, warmup=0)
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


def fb_kernel_phase(rng: np.random.Generator, params, dev) -> dict:
    """B4 and B5 at the training path's shapes: NL chunks of Tp = 65,536
    steps, ragged lengths (a short last lane, PAD tails), the flagship
    model's tables; B5 with the chunked caller's zero enters and pair0
    mask."""
    K, S = params.n_states, params.n_symbols
    chunks = rng.integers(0, S, size=(FB_NL, FB_TP)).astype(np.uint8)
    lengths = np.full(FB_NL, FB_TP, np.int32)
    lengths[-1] = FB_TP // 5
    ragged = rng.random(FB_NL) < 0.25
    lengths[:-1][ragged[:-1]] = rng.integers(1, FB_TP, size=int(ragged[:-1].sum()))
    chunks[np.arange(FB_TP)[None, :] >= lengths[:, None]] = S
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(dev),
                           torch.from_numpy(lengths).to(dev), t_tile=fb_chunked.DEFAULT_T_TILE)
    gt = OH._groups(params)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    tab = FB.prob_tab_ext(params, gt)
    fb_args = (prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, FB_TP)
    al_k, be_k = FB.oh_fwdbwd(*fb_args)
    al_p, be_p = FB.oh_fwdbwd_plain(*fb_args)
    torch.cuda.synchronize()
    equal = torch.equal(al_k, al_p) and torch.equal(be_k, be_p)
    err = max(max_abs_err(al_k, al_p), max_abs_err(be_k, be_p))
    del al_p, be_p
    Tp, NL = prep.pair2.shape
    steps_n = Tp * NL
    results = {"oh_fwdbwd": kernel_row(
        "oh_fwdbwd", equal, err, lambda: FB.oh_fwdbwd(*fb_args),
        lambda: FB.oh_fwdbwd_plain(*fb_args),
        # pair + pairn read, alphas + betas written, per step
        n_bytes=8 * steps_n + 16 * steps_n + 4 * NL + 16 * NL + tab.numel() * 4,
        n_ops=2 * 7 * steps_n, steps=steps_n, plain_runs=1, bit_equal=equal,
    )}
    if not equal:
        raise SystemExit("chip_smoke: oh_fwdbwd disagrees with its plain version")

    assert not torch.backends.cuda.matmul.allow_tf32
    B_red = params.B[gt, torch.arange(S, device=dev)[:, None]].contiguous()
    zeros = lambda rows: torch.zeros((rows, NL), dtype=torch.float32, device=dev)
    st_args = (al_k, be_k, prep.pair2, prep.lens2, tab, B_red,
               gt.to(torch.int32).contiguous(), zeros(K), zeros(2), zeros(1))
    got = FB.oh_seq_stats(*st_args, prep.Tt)
    want = FB.oh_seq_stats_plain(*st_args)
    torch.cuda.synchronize()
    agree = all(torch.allclose(g, w, rtol=1e-5, atol=1e-3) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    del want
    valid = int(np.minimum(lengths, Tp).sum())  # B5 reads valid steps only
    results["oh_seq_stats"] = kernel_row(
        "oh_seq_stats", agree, err, lambda: FB.oh_seq_stats(*st_args, prep.Tt),
        lambda: FB.oh_seq_stats_plain(*st_args),
        n_bytes=20 * valid + 4 * NL + (K * K + 2 * S + 1) * NL * 4,
        n_ops=40 * valid, steps=valid, plain_runs=1, tolerance="rtol 1e-5, atol 1e-3",
    )
    if not agree:
        raise SystemExit("chip_smoke: oh_seq_stats disagrees with its plain version")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the main path on a seeded chromosome-sized FASTA

_BG = np.array([0.295, 0.205, 0.205, 0.295])  # GC 0.41
_ISLAND = np.array([0.175, 0.325, 0.325, 0.175])  # GC 0.65


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


def to_fasta_bytes(rng: np.random.Generator, name: str, s: np.ndarray) -> bytes:
    """One FASTA record, 60 bases a line, with soft-masked (lowercase) runs
    and N runs over about 1% of the record."""
    text = np.frombuffer(b"ACGT", np.uint8)[s].copy()
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
        f.write(to_fasta_bytes(rng, "chr1", big))
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
        out = os.path.join(tmp, f"islands.{label}.txt")
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


def train_phase(params, fa: str, dev) -> dict:
    """train_file compat then clean, TRAIN_ITERS iterations each with
    convergence 0 (fixed work); B4 and B5 must launch once per iteration."""
    launches = {k: 0 for k in TRAIN_KERNELS}
    for label, compat in (("compat", True), ("clean", False)):
        symbols = chunking.frame(
            codec.encode_file(fa, skip_headers=not compat), chunking.TRAIN_CHUNK,
            drop_remainder=compat,
        ).total
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = pipeline.train_file(fa, params=params, num_iters=TRAIN_ITERS, convergence=0.0,
                                  compat=compat, device=dev)
        wall = time.perf_counter() - t0
        counts = {k: _kernels.launches[k] for k in TRAIN_KERNELS}
        ll = res.logliks
        # EM never lowers the loglik; allow f32 rounding of a ~1e8 sum.
        monotone = all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))
        finite = all(bool(torch.isfinite(x).all()) for x in (
            res.params.log_pi, res.params.log_A, res.params.log_B))
        em_s = res.phases["em"]
        emit({
            "phase": "train", "mode": label, "symbols": symbols, "lanes": -(-symbols // chunking.TRAIN_CHUNK),
            "iterations": res.iterations, "wall_s": wall, "phases_s": res.phases,
            "em_msym_per_s": symbols * res.iterations / em_s / 1e6,
            "estep_ms_per_iter": res.phases["estep"] / res.iterations * 1e3,
            "mstep_ms_per_iter": res.phases["mstep"] / res.iterations * 1e3,
            "logliks": ll, "deltas": res.deltas, "launches": counts,
        })
        if res.iterations != TRAIN_ITERS or any(n != TRAIN_ITERS for n in counts.values()):
            raise SystemExit(f"chip_smoke: {label} training launched {counts} in "
                             f"{res.iterations} iterations, not {TRAIN_ITERS} each")
        if not (monotone and finite):
            raise SystemExit(f"chip_smoke: {label} training is not monotone or not finite")
        for k in TRAIN_KERNELS:
            launches[k] += counts[k]
    return launches


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
    FB.oh_seq_stats = lambda *args: FB.oh_seq_stats_plain(*args[:-1])  # drops Tt
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing or not finite:
        raise SystemExit(f"chip_smoke: run never launched {missing} or wrote a non-finite model")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: where the device time goes


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


def profiled(what: str, fn) -> None:
    """torch.profiler over one call of ``fn`` (already warm): device time by
    kernel name, and the device's busy and idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    emit({
        "phase": "profile", "what": what, "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall if rows else None,
        "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c} for k, us, c in rows[:14]],
    })


def profile_phase(params, big: np.ndarray, fa: str, dev) -> None:
    viterbi_sharded(params, big[: 1 << 20], engine="onehot")  # warm caches
    profiled(f"viterbi_sharded, {big.size} symbols",
             lambda: viterbi_sharded(params, big, engine="onehot"))

    # One EM iteration of the compat training batch, as fit runs it: the
    # E-step, the M-step and the one fetch of delta and loglik.
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
    profiled(f"one EM iteration, {chunked.num_chunks} chunks of {chunking.TRAIN_CHUNK}",
             em_iteration)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    emit({"phase": "card", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for rep in _kernels.build_info.get("nvcc_report", {}).values()
                    for ln in rep.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    rng = np.random.default_rng(args.seed)
    params = presets.durbin_cpg8(device=dev)
    results = kernel_phase(rng, params, dev)
    results |= fb_kernel_phase(rng, params, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fa, big, launches = main_path_phase(rng, params, tmp, dev)
        launches |= train_phase(params, fa, dev)
        parity_phase(rng, params, big, tmp, dev)
        run_phase(fa, tmp, dev)
        profile_phase(params, big, fa, dev)

    table = []
    for name, r in results.items():
        table.append({k: r[k] for k in (
            "name", "route", "source", "replaces")} | {"launches": launches[name]} | {
            k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
