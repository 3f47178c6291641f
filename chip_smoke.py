#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout, holds each
one against its plain PyTorch version on the card, drives the decode main
path end to end (a seeded chromosome-sized FASTA, clean and compat modes)
and checks the result.  Phases, one JSON line each:

1. card: name and power limit, kernel build time;
2. kernels: B1-B3 at full size (bk=4096, nb=16384: 64 Mi steps, PAD runs
   and record resets in the pair stream) — bit equality with the plain
   versions, median time, bound and plain-version time;
3. main path: ``pipeline.decode_file`` on a 64 Mi-base record plus 256
   scaffolds, clean then compat, with per-phase wall seconds and the kernel
   launch counts of that run (each must be > 0);
4. parity: the first 4 Mi symbols of the big record decoded through the
   plain versions on the card must give the kernels' path (or, under the
   tie contract, the same f64 path score), and a small FASTA must give
   byte-identical island files on the CPU and on the card;
5. profile: device time by kernel over one decode of the big record, and
   the device's idle share of that decode.

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
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops import viterbi_onehot as OH
from cpgisland_tpu_torch.parallel.decode import viterbi_sharded

BK, NB = 4096, 16384  # the default block; 64 Mi steps
BIG_RECORD = 64 << 20
N_SCAFFOLDS = 256
PARITY_SYMBOLS = 4 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

KERNELS = {
    "oh_products": "cpgisland_tpu/ops/viterbi_onehot.py:401",
    "oh_backpointers": "cpgisland_tpu/ops/viterbi_onehot.py:435",
    "oh_backtrace": "cpgisland_tpu/ops/viterbi_onehot.py:539",
}
SOURCE = "cpgisland_tpu_torch/csrc/viterbi_onehot.cu"


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
        ms = time_ms(kernel_fn, runs=10)
        plain_ms = time_ms(plain_fn, runs=3, warmup=1)
        t_bytes = bytes_moved[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_OPS_PER_S * 1e3
        results[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[name], "bit_equal": equal, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": bytes_moved[name], "steps": steps_n,
        }
        emit({"phase": "kernel", **results[name]})
        if not equal:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
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
    runs = {}
    for label, compat in (("clean", False), ("compat", True)):
        out = os.path.join(tmp, f"islands.{label}.txt")
        t0 = time.perf_counter()
        res = pipeline.decode_file(fa, params, islands_out=out, compat=compat, device=dev)
        wall = time.perf_counter() - t0
        check_calls(res, label)
        runs[label] = res
        emit({
            "phase": "main_path", "mode": label, "symbols": res.n_symbols,
            "records_or_chunks": res.n_chunks, "islands": len(res.calls),
            "wall_s": wall, "phases_s": res.phases,
            "msym_per_s": res.n_symbols / wall / 1e6,
            "decode_msym_per_s": res.n_symbols / res.phases["decode"] / 1e6,
        })
    launches = dict(_kernels.launches)
    emit({"phase": "launches", **launches})
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"chip_smoke: main path never launched {missing}")
    return big, launches


# ---------------------------------------------------------------------------
# Phase 4: parity of the kernel path with the plain path


def path_score_f64(params, obs: np.ndarray, path: np.ndarray) -> float:
    lp = params.log_pi.double().cpu().numpy()
    lA = params.log_A.double().cpu().numpy()
    lB = params.log_B.double().cpu().numpy()
    o = obs.astype(np.int64)
    p = path.astype(np.int64)
    return float(lp[p[0]] + lB[p[0], o[0]] + lA[p[:-1], p[1:]].sum() + lB[p[1:], o[1:]].sum())


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

    fa = os.path.join(tmp, "small.fa")
    with open(fa, "wb") as f:
        for i in range(3):
            f.write(to_fasta_bytes(rng, f"r{i}", make_sequence(rng, 40_000 + 7_000 * i)))
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


# ---------------------------------------------------------------------------
# Phase 5: where the time of one whole-record decode goes


def profile_phase(params, big: np.ndarray) -> None:
    """torch.profiler over one decode of the big record: device time by
    kernel name, and the device's busy and idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    viterbi_sharded(params, big[: 1 << 20], engine="onehot")  # warm caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        viterbi_sharded(params, big, engine="onehot")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # Device-side events only (kernels, copies): a host operator also
        # carries its kernels' device time and would count it twice.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    emit({
        "phase": "profile", "what": f"viterbi_sharded, {big.size} symbols",
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall if rows else None,
        "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c} for k, us, c in rows[:14]],
    })


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
          "ptxas": [ln.strip() for ln in _kernels.build_info.get("nvcc_report", "").splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    rng = np.random.default_rng(args.seed)
    params = presets.durbin_cpg8(device=dev)
    results = kernel_phase(rng, params, dev)
    with tempfile.TemporaryDirectory() as tmp:
        big, launches = main_path_phase(rng, params, tmp, dev)
        parity_phase(rng, params, big, tmp, dev)
    profile_phase(params, big)

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
