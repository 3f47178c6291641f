"""Drive the port's mesh paths on a mesh of n entries and check them.

The counterpart of the JAX package's ``dryrun_multichip`` body: one EM step
data-parallel through ``SpmdBackend``; one record decoded sequence-parallel
(``viterbi_sharded``), and again in two spans, which must be equal; the
sharded posterior on the lane path and on the reduced kernels (within
atol 2e-5 of each other); the reduced decode equal to the dense one; the
device island caller equal to the host one on a sharded path; and one
whole-sequence EM step through ``SeqBackend`` on the mesh, on the kernels
and on the lane path (logliks within rtol 1e-5).

    python -m cpgisland_tpu_torch.tools.dryrun_mesh [--n 4] [--device cuda:0]

``--device cpu`` or ``cuda:N`` builds a mesh of n entries that all name that
device (the counterpart of the JAX tests' virtual CPU devices); ``cuda``
takes n cards (``parallel.mesh.make_mesh``, which raises when there are
fewer).  Prints one JSON line with each check's outcome and seconds; exits
1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _mesh(n: int, device: str, axis: str):
    from cpgisland_tpu_torch.parallel.mesh import Mesh, make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(n, axis=axis, device=dev)
    return Mesh([dev] * n, (axis,))


def dryrun(n: int, device: str = "cuda") -> dict:
    """Run every check on a mesh of ``n`` entries of ``device``; returns
    {check: seconds}.  An AssertionError names the failing check."""
    from cpgisland_tpu_torch.models import presets
    from cpgisland_tpu_torch.ops import islands as islands_mod
    from cpgisland_tpu_torch.ops.islands_device import call_islands_device
    from cpgisland_tpu_torch.parallel.decode import viterbi_sharded, viterbi_sharded_spans
    from cpgisland_tpu_torch.parallel.posterior import posterior_sharded
    from cpgisland_tpu_torch.train import baum_welch
    from cpgisland_tpu_torch.train.backends import SeqBackend, SpmdBackend
    from cpgisland_tpu_torch.utils import chunking

    rng = np.random.default_rng(0)
    seq_mesh = _mesh(n, device, "seq")
    params = presets.durbin_cpg8().to(seq_mesh.first)
    times: dict = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if seq_mesh.first.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    # dp: chunks split over the data axis, one EM step.
    syms = rng.integers(0, 4, size=n * 2 * 512).astype(np.uint8)
    res = timed("dp_em_step", lambda: baum_welch.fit(
        params, chunking.frame(syms, 512), num_iters=1, convergence=0.0,
        backend=SpmdBackend(mesh=_mesh(n, device, "data"))))
    assert res.iterations == 1 and np.isfinite(res.logliks[0]), "dp_em_step"
    one = baum_welch.fit(params, chunking.frame(syms, 512), num_iters=1, convergence=0.0)
    assert abs(res.logliks[0] - one.logliks[0]) <= 1e-5 * abs(one.logliks[0]), "dp_vs_local"

    # sp: one record over the mesh, then the same record in two spans.
    obs = rng.integers(0, 4, size=n * 1024).astype(np.uint8)
    path = timed("sp_decode", lambda: viterbi_sharded(params, obs, mesh=seq_mesh,
                                                      block_size=128, engine="xla"))
    assert path.shape == obs.shape and 0 <= path.min() and path.max() < 8, "sp_decode"
    spans = timed("sp_decode_spans", lambda: viterbi_sharded_spans(
        params, obs, span=obs.size // 2, mesh=seq_mesh, block_size=128, engine="xla"))
    assert np.array_equal(np.concatenate(spans), path), "sp_decode_spans"
    path_oh = timed("sp_decode_onehot", lambda: viterbi_sharded(
        params, obs, mesh=seq_mesh, block_size=128, engine="onehot"))
    assert np.array_equal(path_oh, path), "sp_decode_onehot"

    # sp soft decoding: the lane path and the reduced kernels.
    conf, _ = timed("sp_posterior", lambda: posterior_sharded(
        params, obs, tuple(range(4)), mesh=seq_mesh, block_size=128, engine="xla"))
    assert conf.shape == obs.shape and np.isfinite(conf).all(), "sp_posterior"
    assert float(conf.min()) >= 0.0 and float(conf.max()) <= 1.0 + 1e-6, "sp_posterior_range"
    conf_oh, _ = timed("sp_posterior_onehot", lambda: posterior_sharded(
        params, obs, tuple(range(4)), mesh=seq_mesh, engine="onehot", lane_T=512))
    assert np.allclose(conf_oh, conf, atol=2e-5), "sp_posterior_onehot"

    # sp + the device island caller on a sharded path (a planted GC core).
    gc_obs = rng.integers(0, 4, size=n * 1024).astype(np.uint8)
    lo, hi = len(gc_obs) // 3, 2 * len(gc_obs) // 3
    gc_obs[lo:hi] = rng.choice([1, 2], size=hi - lo)
    path_dev = timed("sp_device_islands", lambda: viterbi_sharded(
        params, gc_obs, mesh=seq_mesh, block_size=128, return_device=True))
    dev_calls = call_islands_device(path_dev, min_len=None)
    host_calls = islands_mod.call_islands(path_dev.cpu().numpy(), chunk=0, compat=False)
    assert len(dev_calls) >= 1 and dev_calls.format_lines() == host_calls.format_lines(), \
        "sp_device_islands"

    # sp training: one whole-sequence EM step on the kernels and on the lane path.
    long_obs = rng.integers(0, 4, size=n * 512 + 77).astype(np.uint8)
    lls = {}
    for eng in ("auto", "xla"):
        r = timed(f"sp_em_step_{eng}", lambda eng=eng: baum_welch.fit(
            params, chunking.frame(long_obs, 1024), num_iters=1, convergence=0.0,
            backend=SeqBackend(mesh=seq_mesh, block_size=128, engine=eng, lane_T=256)))
        assert np.isfinite(r.logliks[0]), f"sp_em_step_{eng}"
        lls[eng] = r.logliks[0]
    assert abs(lls["auto"] - lls["xla"]) <= 1e-5 * abs(lls["xla"]), "sp_em_kernels_vs_lane"
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4, help="mesh entries")
    ap.add_argument("--device", default="cuda",
                    help="cpu or cuda:N (n entries naming it) or cuda (n cards)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("dryrun_mesh: CUDA is not available; pass --device cpu", file=sys.stderr)
        return 2
    try:
        times = dryrun(args.n, args.device)
    except AssertionError as e:
        print(json.dumps({"ok": False, "n": args.n, "device": args.device,
                          "failed": str(e)}))
        return 1
    print(json.dumps({"ok": True, "n": args.n, "device": args.device,
                      "seconds": {k: round(v, 4) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
