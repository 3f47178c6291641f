"""Pair composition of the reduced forward chain: four lowerings timed on
identical inputs.

    python -m cpgisland_tpu_torch.tools.bench_compose [--mib 64]
        [--lane-T 65536] [--chain 8] [--device cuda|cpu]

Counterpart of the JAX package's ``tools/bench_compose.py``.  The forward
chain bounds the posterior and EM; composing two steps halves its serial
depth.  The inputs are ``--mib`` Mi random symbols of the flagship's
4-letter alphabet from ``np.random.default_rng(0)``, as lanes of
``--lane-T`` steps, every pair real and every lane full.  The variants:

- ``single`` (T1): B9, the shipped forward kernel (``fb_onehot.oh_fwd``);
- ``single-strm`` (T2): the same chain, each step's four matrix entries
  streamed from device memory (``fb_compose.oh_fwd_strm``);
- ``composed`` (T3): the double-step chain over precomposed streams
  (``fb_compose.oh_fwd_comp``);
- ``composed-sel`` (T4): T3's chain with the composed matrices looked up in
  the kernel from tables (``fb_compose.oh_fwd_compsel``).

All four run each lane as B9's G = ``fb_onehot.sublanes(--lane-T)``
sub-lanes (16 at the default 65,536 steps, 4 at 16,384, 1 at 4,096) joined
by exact messages, so T1 against T2 (a table lookup against a streamed
matrix), T1 against T3 (one step against two) and T3 against T4 (streamed
composed matrices against looked-up ones) compare at equal parallelism.

Each is first gated against the single-step plain reference, the
sequential chain at every lane length (``fb_onehot.fwd_chain_plain``, the
twin of the JAX package's ``_xla_fwd_onehot``; the sub-lanes round apart
from it) on the first GATE_LANES lanes: max relative error
below 1e-4, with a 1e-3 floor on the reference.  Then it is timed with CUDA
events, the median over ``--chain`` calls, twice: the whole variant (its
streams or tables built from the pairs, as the JAX script times it) and
its kernel alone.  Progress goes to stderr; the result is one JSON line on
stdout, with the card's name and power limit (``nvidia-smi``).

``--device cpu`` runs the plain versions at the JAX script's off-TPU size
(256 Ki symbols, lanes of 2,048; ``--mib`` and ``--lane-T`` are ignored),
timed by the host clock: its line says ``"engine": "plain"`` and its rates
are no speed.  The default ``--device cuda`` exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.ops import fb_compose as FC
from cpgisland_tpu_torch.ops import fb_onehot as FB
from cpgisland_tpu_torch.ops.viterbi_onehot import GROUP, _groups

# variant -> the kernel (launch counter) that runs it
KERNEL_OF = {"single": "oh_fwd", "single-strm": "oh_fwd_strm", "composed": "oh_fwd_comp",
             "composed-sel": "oh_fwd_compsel"}
GATE_LANES = 256
GATE_TOL, GATE_FLOOR = 1e-4, 1e-3
CPU_SYMBOLS, CPU_LANE_T = 256 << 10, 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def inputs(T: int, lane_T: int, dev):
    """(pair2 [lane_T, NL] int32, lens2 [1, NL] int32, a0 [2, NL] f32): the
    JAX script's seeded inputs, T symbols as NL = T / lane_T full lanes."""
    if T % lane_T:
        raise SystemExit("bench_compose: the symbol count must divide into lanes of --lane-T")
    NL = T // lane_T
    S = 4
    rng = np.random.default_rng(0)
    syms = rng.integers(0, S, size=T + 1, dtype=np.int32)
    pair2 = np.ascontiguousarray((syms[:-1] * S + syms[1:]).reshape(NL, lane_T).T)
    a0 = rng.random((GROUP, NL)).astype(np.float32) + 0.1
    lens2 = torch.full((1, NL), lane_T, dtype=torch.int32, device=dev)
    return torch.from_numpy(pair2).to(dev), lens2, torch.from_numpy(a0).to(dev)


def pair_tables(dev) -> tuple:
    """The flagship's pair table [16, 4] and B9's [17, 4] (the identity
    last)."""
    params = presets.durbin_cpg8(device=dev)
    gt = _groups(params)
    return FB.prob_pair_table(params, gt).contiguous(), FB.prob_tab_ext(params, gt)


def variants(tab: torch.Tensor, tab_ext: torch.Tensor, lens2: torch.Tensor,
             a0: torch.Tensor) -> dict:
    """name -> (build, launch): ``build(pair2)`` makes the variant's
    operands from the pairs, ``launch(operands)`` runs its kernel (its
    plain version on the CPU) -> alphas [Tp, 2, NL]."""
    S = math.isqrt(tab.shape[0])
    return {
        "single": (lambda p: p, lambda p: FB.oh_fwd(p, lens2, a0, tab_ext)),
        "single-strm": (lambda p: FC.mat_streams(tab, p),
                        lambda m: FC.oh_fwd_strm(m, lens2, a0)),
        "composed": (lambda p: FC.composed_streams(tab, p),
                     lambda c: FC.oh_fwd_comp(c, lens2, a0)),
        "composed-sel": (lambda p: (FC.compsel_index(p, S), *FC.composed_tables(tab)),
                         lambda o: FC.oh_fwd_compsel(o[0], lens2, a0, *o[1:])),
    }


def traffic(name: str, Tp: int, NL: int, S: int = 4) -> tuple:
    """(bytes, f32 operations) of a variant's kernel: each input read once,
    the alphas [Tp, 2, NL] written once."""
    n = Tp * NL
    lanes = 12 * NL  # lens2 and a0
    if name == "single":  # the pairs; 4 multiplies, 3 adds, a division, 2 scalings a step
        return 4 * n + 8 * n + lanes + (S * S + 1) * 16, 10 * n
    if name == "single-strm":  # four f32 entries a step
        return 16 * n + 8 * n + lanes, 10 * n
    if name == "composed":  # ten f32 streams a double step; 22 operations
        return 20 * n + 8 * n + lanes, 11 * n
    if name == "composed-sel":  # two int32 indices a double step, the tables
        return 4 * n + 8 * n + lanes + (S * S * (S + 2) * 4 + (S * S + 1) * 6) * 4, 11 * n
    raise KeyError(name)


def bound_ms(name: str, Tp: int, NL: int, S: int = 4) -> float:
    """The least time the H100 could take for the kernel's work: bytes over
    its memory rate or operations over its f32 rate, the larger."""
    n_bytes, n_ops = traffic(name, Tp, NL, S)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


def gate_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The JAX script's gate: max |got - ref| / max(|ref|, 1e-3)."""
    return float(((got - ref).abs() / ref.abs().clamp_min(GATE_FLOOR)).max())


def _median_ms(fn, runs: int, cuda: bool) -> float:
    """Median of ``runs`` calls after one warm-up: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    times = []
    for _ in range(runs):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run(T: int, lane_T: int, chain: int, dev) -> dict:
    """Gate and time every variant -> the result line's object."""
    cuda = dev.type == "cuda"
    tab, tab_ext = pair_tables(dev)
    pair2, lens2, a0 = inputs(T, lane_T, dev)
    Tp, NL = pair2.shape
    ng = min(NL, GATE_LANES)
    pair_g, lens_g, a0_g = (x[:, :ng].contiguous() for x in (pair2, lens2, a0))
    print(f"bench_compose: {T} symbols, {NL} lanes of {Tp}, gate on {ng} lanes, "
          f"device {dev}", file=sys.stderr)
    ref = FB.fwd_chain_plain(FB._step_matrices(tab_ext, pair_g, [0, 1, 2, 3]), lens_g, a0_g)
    gate_fns = variants(tab, tab_ext, lens_g, a0_g)
    fns = variants(tab, tab_ext, lens2, a0)
    out, calls = {}, {}
    for name, (build, launch) in fns.items():
        g_build, g_launch = gate_fns[name]
        err = gate_err(g_launch(g_build(pair_g)), ref)
        print(f"{name}: max rel err vs the single-step reference = {err:.2e}", file=sys.stderr)
        if not err < GATE_TOL:
            raise SystemExit(f"bench_compose: {name} fails the gate (err {err:.2e})")
        operands = build(pair2)
        whole_ms = _median_ms(lambda: launch(build(pair2)), chain, cuda)
        kernel_ms = _median_ms(lambda: launch(operands), chain, cuda)
        del operands
        calls[KERNEL_OF[name]] = 1 + 2 * (1 + chain)
        out[name] = {
            "kernel": KERNEL_OF[name], "msym_s": T / whole_ms / 1e3, "ms": whole_ms,
            "kernel_ms": kernel_ms, "bound_ms": bound_ms(name, Tp, NL) if cuda else None,
            "gate_err": err,
        }
        print(f"{name}: {T / whole_ms / 1e3:.1f} Msym/s ({whole_ms:.3f} ms; kernel "
              f"{kernel_ms:.3f} ms)", file=sys.stderr)
    return {
        "bench": "compose", "engine": "cuda" if cuda else "plain",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_line() if cuda else None, "symbols": T, "lanes": NL, "lane_T": Tp,
        "chain": chain, "gate_lanes": ng, "variants": out, "calls": calls,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--lane-T", type=int, default=65536)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("bench_compose: CUDA is not available (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 2
        T, lane_T = args.mib << 20, args.lane_T
    else:
        T, lane_T = CPU_SYMBOLS, CPU_LANE_T
    print(json.dumps(run(T, lane_T, args.chain, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
