"""Device time of one record's posterior on the fused and the split arm,
single-model and stacked: the measurement behind the split chains'
sub-lane rules, comparable across commits.

    python cpgisland_tpu_torch/tools/time_posteriors.py [--root DIR] [--runs 21] [--seed 0]

The record is 64 Mi symbols of the flagship's 4-letter alphabet from
``np.random.default_rng(--seed)``, on the card once, laid out as 8,192
lanes of ``fb_seq.DEFAULT_LANE_T`` steps (the posterior's lanes).  Each
case is timed with CUDA events over ``--runs`` calls after two warm-ups
(the median and the least), up to its device outputs (no copy to the
host), and its kernel launches are counted over one call:

- ``single_conf`` / ``single_path``: ``fb_seq.seq_posterior`` of the
  flagship, the island confidence alone / with the MPM path;
- ``stacked_conf``: ``fb_seq.seq_posterior_stacked`` of the flagship and a
  random partition=2 member (``presets.random_hmm``, torch seed
  ``--seed``), the confidence alone;

each on the fused arm and on the split arm (``fused=False``).  ``--root``
imports ``cpgisland_tpu_torch`` from another checkout (a parent commit
unpacked with ``git archive``), so that two commits are timed on one card
in one call, in turns: parent, change, change, parent.  Prints the card's
name and power limit (``nvidia-smi``), then one JSON line; exits 2
without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

NL = 8192
ISLANDS = ((0, 1, 2, 3), (0, 3, 6))  # the flagship's island states, the member's


def _times_ms(torch, fn, runs: int) -> list:
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = str(pathlib.Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    from cpgisland_tpu_torch.models import presets
    from cpgisland_tpu_torch.ops import _kernels, fb_seq

    if not torch.cuda.is_available():
        print("time_posteriors: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    lane_T = fb_seq.DEFAULT_LANE_T
    T = NL * lane_T
    gen = torch.Generator().manual_seed(args.seed)
    members = [presets.durbin_cpg8(device=dev),
               presets.random_hmm(gen, 8, 4, partition=2, device=dev)]
    masks = []
    for states in ISLANDS:
        m = np.zeros(8, np.float32)
        m[list(states)] = 1.0
        masks.append(m)
    rng = np.random.default_rng(args.seed)
    placed = torch.from_numpy(rng.integers(0, 4, size=T, dtype=np.uint8)).to(dev)
    cases = {
        "single_conf": lambda fused: fb_seq.seq_posterior(
            members[0], placed, T, masks[0], lane_T=lane_T, fused=fused),
        "single_path": lambda fused: fb_seq.seq_posterior(
            members[0], placed, T, masks[0], want_path=True, lane_T=lane_T, fused=fused),
        "stacked_conf": lambda fused: fb_seq.seq_posterior_stacked(
            members, placed, T, masks, lane_T=lane_T, fused=fused),
    }
    out = {}
    for name, fn in cases.items():
        for fused in (True, False):
            _kernels.reset_launches()
            fn(fused)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _kernels.launches.items() if v}
            key = f"{name}_{'fused' if fused else 'split'}"
            times = _times_ms(torch, lambda: fn(fused), args.runs)
            out[key] = {"ms": statistics.median(times), "min_ms": min(times),
                        "launches": launches}
            print(f"{key}: {out[key]['ms']:.3f} ms {launches}", file=sys.stderr)
    print(json.dumps({"tool": "time_posteriors", "root": root, "card": card, "symbols": T,
                      "lanes": NL, "lane_T": lane_T, "runs": args.runs, "cases": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
