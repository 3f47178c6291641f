"""Variant builds of the sub-lane forward-backward kernels and of B5, timed
on identical inputs: the measurements behind their layouts.

    python -m cpgisland_tpu_torch.tools.kernel_variants

Each variant is a copy of ``csrc/fb_dense.cu`` or ``csrc/fb_onehot.cu`` with
a few lines replaced (the table below), compiled with the port's nvcc flags
into ``build/kernel_variants/`` and called through its C interface, so a
variant changes nothing in the package.  On the card only: B16 and B18 at
K = 2 (two_state) in sub-lanes on 1,024 ragged chunks of 65,536 steps (G =
32) and on 8,192 lanes of 8,192 steps (G = 16 and 8), and B5 (the flagship)
on 1,024 and the genome's 1,390 ragged chunks of 65,536 steps and on 8,192
and the genome's 11,121 seq lanes of 8,192 steps, at segments of 128 to
1,024 steps.  Each variant's outputs are held against the unchanged build
(bit for bit for B16 and B18, within rtol 1e-5 / atol 1e-3 for the B5
layouts; the ``diag_*`` variants drop work to find what bounds B5 and are
not checked).  Times: CUDA events, median of 15.  One JSON line per
variant on stdout, after the card's name and power limit (``nvidia-smi``);
exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.ops import _kernels, fb_chunked
from cpgisland_tpu_torch.ops import fb_onehot as FB
from cpgisland_tpu_torch.ops import fb_pallas as FP
from cpgisland_tpu_torch.ops.prepared import prepare_chunked, prepare_seq
from cpgisland_tpu_torch.ops.viterbi_onehot import _groups
from cpgisland_tpu_torch.tools.bench_compose import card_line

OUT_DIR = _kernels.BUILD_DIR.parent / "kernel_variants"
# name -> (source stem, replacements)
VARIANTS = {
    "dense/base": ("fb_dense", []),
    "dense/threads64": ("fb_dense", [("#define CHAIN_THREADS 32", "#define CHAIN_THREADS 64")]),
    "dense/threads128": ("fb_dense", [("#define CHAIN_THREADS 32", "#define CHAIN_THREADS 128")]),
    "dense/lookahead16": ("fb_dense", [("#define LOOKAHEAD 8", "#define LOOKAHEAD 16")]),
    "dense/frcp": ("fb_dense", [("__fdiv_rn(1.0f, seq_sum<K>(v))", "__frcp_rn(seq_sum<K>(v))"),
                                ("__fdiv_rn(1.0f, c)", "__frcp_rn(c)")]),
    "stats/base": ("fb_onehot", []),
    "stats/lanes128": ("fb_onehot", [("#define STATS_LANES 32", "#define STATS_LANES 128")]),
    "stats/ahead4": ("fb_onehot", [("#define STATS_AHEAD 8", "#define STATS_AHEAD 4")]),
    "stats/ahead12": ("fb_onehot", [("#define STATS_AHEAD 8", "#define STATS_AHEAD 12")]),
    "stats/ahead16": ("fb_onehot", [("#define STATS_AHEAD 8", "#define STATS_AHEAD 16")]),
    "stats/fdiv": ("fb_onehot", [("__frcp_rn(", "__fdiv_rn(1.0f, ")]),
    "stats/diag_nolog": ("fb_onehot", [("logf(fmaxf(cs, 1e-30f))", "fmaxf(cs, 1e-30f)")]),
    "stats/diag_loads": ("fb_onehot", [(
        "stats_step<false>(q.a0[r], q.a1[r], q.b0[r], q.b1[r], q.d[r], ah0, ah1, ll, my, bd,\n"
        "                          s_tab, s_bred, s_igt, enters_full, enters_red, pair0, nl, S, K);",
        "ll = __fadd_rn(ll, q.a0[r] + q.a1[r] + q.b0[r] + q.b1[r] + (float)q.d[r]);")]),
}
_SPB_CHECK = ("(SPB != 1 && SPB != 4)", "(SPB < 1)")  # lanes128 runs one segment a block
SEGMENTS = (128, 256, 512, 1024)
# The kernels whose registers and spills each variant build prints.
PTXAS_OF = {"dense": ("_Z17fb_fwd_sub_kernelILi2E", "_Z17fb_bwd_sub_kernelILi2E"),
            "stats": ("_Z24oh_seq_stats_part_kernel",)}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_all() -> dict:
    """variant -> the loaded library (all nvcc runs started together)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (stem, reps) in VARIANTS.items():
        src = (_kernels._CSRC / f"{stem}.cu").read_text()
        for a, b in reps + ([_SPB_CHECK] if stem == "fb_onehot" else []):
            if a not in src:
                raise RuntimeError(f"{name}: {a!r} not in {stem}.cu")
            src = src.replace(a, b)
        tag = name.replace("/", "_")
        path, lib = OUT_DIR / f"{tag}.cu", OUT_DIR / f"lib{tag}.so"
        path.write_text(src)
        procs[name] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
        print(json.dumps({"variant": name, "ptxas": ptxas(err, PTXAS_OF[name.split("/")[0]])}),
              flush=True)
    return libs


def ptxas(report: str, names) -> dict:
    """Kernel (mangled) -> its ptxas registers and spills, for the kernels
    whose names start with one of ``names``."""
    out, lines = {}, report.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            if fn.startswith(names):
                out[fn] = " | ".join(x.split("info    :")[-1].strip() for x in lines[i + 2 : i + 4])
    return out


def c_fn(lib, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
    fn.restype = _I

    def call(tensors, ints):
        err = fn(*[t.data_ptr() for t in tensors], *ints,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def time_ms(fn, runs: int = 15) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ragged(rng, S: int, NL: int, Tp: int, dev):
    chunks = rng.integers(0, S, size=(NL, Tp)).astype(np.uint8)
    lengths = np.full(NL, Tp, np.int32)
    lengths[-1] = Tp // 5
    cut = rng.random(NL) < 0.25
    lengths[:-1][cut[:-1]] = rng.integers(1, Tp, size=int(cut[:-1].sum()))
    chunks[np.arange(Tp)[None, :] >= lengths[:, None]] = S
    return torch.from_numpy(chunks).to(dev), torch.from_numpy(lengths).to(dev)


def dense_inputs(rng, dev) -> dict:
    """geometry -> (steps2, lens2, a0, beta0, G) for two_state."""
    two = presets.two_state_cpg(device=dev)
    prep = prepare_chunked(4, *ragged(rng, 4, 1024, 65536, dev), t_tile=512, onehot=False)
    _, a0, beta0, _ = fb_chunked._batch_lane_setup(two, prep)
    n = 8192
    obs = torch.from_numpy(rng.integers(0, 4, size=n * n).astype(np.uint8)).to(dev)
    seq = prepare_seq(4, obs, n * n - 3000, lane_T=n, onehot=False)
    v = lambda: torch.from_numpy(rng.random((2, n)).astype(np.float32) + 0.01).to(dev)  # noqa: E731
    lens = seq.lane_lens[None, :].contiguous()
    return {"train": (prep.steps2, prep.lens2, a0, beta0, 32),
            "post16": (seq.steps2, lens, v(), v(), 16), "post8": (seq.steps2, lens, v(), v(), 8)}


def stats_inputs(rng, dev) -> dict:
    """shape -> B5's operands (the flagship) on B4's streams: ragged chunks
    of 65,536 steps (1,024, and the genome's 1,390) with zero enters, and
    seq lanes of 8,192 steps (8,192, and the genome's 11,121) with random
    enters, every lane's t == 0 pair but lane 0's."""
    fl = presets.durbin_cpg8(device=dev)
    gt = _groups(fl)
    tab = FB.prob_tab_ext(fl, gt)
    head = (tab, FB.reduced_emissions(fl, gt), gt.to(torch.int32).contiguous())
    out = {}
    for NL in (1024, 1390):
        prep = prepare_chunked(4, *ragged(rng, 4, NL, 65536, dev), t_tile=512)
        _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(fl, prep)
        a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
        b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
        al, be = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, 65536)
        z = lambda r: torch.zeros((r, NL), dtype=torch.float32, device=dev)  # noqa: E731
        out[f"train{NL}"] = (al, be, prep.pair2, prep.lens2, *head, z(8), z(2), z(1))
    for NL in (8192, 11121):
        obs = torch.from_numpy(rng.integers(0, 4, size=NL * 8192).astype(np.uint8)).to(dev)
        seq = prepare_seq(4, obs, NL * 8192 - 3000, lane_T=8192)
        lens = seq.lane_lens[None, :].contiguous()
        v = lambda r: torch.from_numpy(  # noqa: E731
            rng.random((r, NL)).astype(np.float32) + 0.01).to(dev)
        al, be = FB.oh_fwdbwd(seq.pair2, seq.pairn2, lens, v(2), v(2), tab, 8192)
        p0 = torch.ones((1, NL), dtype=torch.float32, device=dev)
        p0[0, 0] = 0.0
        out[f"seq{NL}"] = (al, be, seq.pair2, lens, *head, v(8), v(2), p0)
    return out


def run_dense(name, lib, inputs, A, B, ref) -> dict:
    fwd, bwd = c_fn(lib, "fb_fwd", 7, 5), c_fn(lib, "fb_bwd", 8, 6)
    row = {"variant": name}
    for geo, (steps, lens, a0, b0, G) in inputs.items():
        Tp, NL = steps.shape
        al, pb = torch.empty((Tp, 2, NL), device=steps.device), torch.empty((G, 4, NL),
                                                                               device=steps.device)
        f = lambda: fwd([steps, lens, a0, A, B, al, pb], [Tp, NL, 2, 4, G])  # noqa: E731
        row[f"fwd_{geo}_ms"] = time_ms(f)
        f()
        _, sn, csn = FP.backward_inputs(steps, al)
        be, qb = torch.empty_like(al), torch.empty((G, 5, NL), device=steps.device)
        g = lambda: bwd([sn, lens, csn, b0, A, B, be, qb], [Tp, NL, 2, 4, Tp, G])  # noqa: E731
        row[f"bwd_{geo}_ms"] = time_ms(g)
        g()
        if geo not in ref:
            ref[geo] = (al, be)
        else:
            row[f"{geo}_bit_equal"] = bool(torch.equal(al, ref[geo][0])
                                           and torch.equal(be, ref[geo][1]))
    return row


def run_stats(name, lib, inputs, want) -> dict:
    fn = c_fn(lib, "oh_seq_stats", 14, 6)
    spb = 1 if name == "stats/lanes128" else 4
    row = {"variant": name}
    for shape, sa in inputs.items():
        Tp, NL = sa[2].shape
        for seg in SEGMENTS:
            rows = -(-(-(-Tp // seg)) // spb)
            part = torch.empty((rows, 73, NL), device=sa[0].device)
            out = [torch.empty((r, NL), device=sa[0].device) for r in (64, 8, 1)]
            f = lambda: fn([*sa, part, *out], [Tp, NL, 4, 8, seg, spb])  # noqa: E731
            row[f"{shape}_{seg}_ms"] = time_ms(f)
            f()
            if not name.startswith("stats/diag"):
                row[f"{shape}_{seg}_agrees"] = all(
                    torch.allclose(a, b, rtol=1e-5, atol=1e-3) for a, b in zip(out, want[shape]))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    libs = build_all()
    rng = np.random.default_rng(0)
    A, B, _ = FP.tables(presets.two_state_cpg(device=dev))
    inputs, ref = dense_inputs(rng, dev), {}
    for name, lib in libs.items():
        if name.startswith("dense/"):
            print(json.dumps(run_dense(name, lib, inputs, A, B, ref)), flush=True)
    del inputs, ref
    torch.cuda.empty_cache()
    inputs = stats_inputs(rng, dev)
    want = {k: FB.oh_seq_stats_plain(*sa) for k, sa in inputs.items()}
    for name, lib in libs.items():
        if name.startswith("stats/"):
            print(json.dumps(run_stats(name, lib, inputs, want)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
