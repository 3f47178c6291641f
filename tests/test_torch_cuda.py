"""Kernel-vs-plain checks that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip on a machine without a card;
``python3 chip_smoke.py`` runs the same comparisons at full size there.
Run them on the card with ``python -m pytest --noconftest
tests/test_torch_cuda.py -m cuda`` (the suite's conftest imports JAX, which
a GPU host need not have).  Max-plus is adds and maxes only, and the
forward-backward chains run with FMA contraction off: those kernels equal
their plain versions bit for bit.  The stats reduction sums in another
order than its plain version and is held to a stated tolerance.
"""

import io

import numpy as np
import pytest
import torch

from cpgisland_tpu_torch import pipeline
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops import viterbi_onehot as OH

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bk,nb", [(8, 1), (64, 130), (4096, 257)])
def test_kernels_equal_plain_versions(cuda_device, bk, nb):
    rng = np.random.default_rng(bk + nb)
    params = presets.durbin_cpg8(device=cuda_device)
    steps = rng.integers(0, 5, size=(bk, nb)).astype(np.int32)
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01).to(cuda_device)
    steps_d = torch.from_numpy(steps).to(cuda_device)
    _, _, tab, idtab, pair2, _, _, _ = OH._prepared(params, steps_d, 1, resets)
    v = torch.from_numpy(rng.normal(size=(2, nb)).astype(np.float32)).to(cuda_device)
    bits = torch.from_numpy(rng.integers(0, 2, size=nb).astype(np.int32)).to(cuda_device)
    decode_kernels = ("oh_products", "oh_backpointers", "oh_backtrace")
    before = {k: _kernels.launches[k] for k in decode_kernels}
    assert torch.equal(OH.oh_products(pair2, tab), OH.oh_products_plain(pair2, tab))
    got = OH.oh_backpointers(pair2, v, tab)
    want = OH.oh_backpointers_plain(pair2, v, tab)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(OH.oh_backtrace(got[0], pair2, idtab, bits),
                       OH.oh_backtrace_plain(got[0], pair2, idtab, bits))
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in before)


def test_decode_file_cuda_equals_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(3)
    p = tmp_path / "x.fa"
    with open(p, "w") as f:
        for r in range(3):
            s = rng.choice(4, size=20_000, p=[0.3, 0.2, 0.2, 0.3])
            s[5000:6500] = rng.choice(4, size=1500, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    outs = {}
    for dev in ("cpu", "cuda"):
        buf = io.StringIO()
        pipeline.decode_file(str(p), presets.durbin_cpg8(), islands_out=buf,
                             compat=False, device=dev)
        outs[dev] = buf.getvalue()
    assert outs["cpu"] == outs["cuda"] and outs["cuda"]


# -- B4 / B5: the chunked E-step kernels ---------------------------------------


def _chunk_batch(rng, NL, T, device):
    """Seeded [NL, T] chunks with ragged lengths (a short last lane, an
    empty lane where NL allows) and PAD tails, prepared on ``device``."""
    from cpgisland_tpu_torch.ops.prepared import prepare_chunked

    chunks = rng.integers(0, 4, size=(NL, T)).astype(np.uint8)
    lengths = np.full(NL, T, np.int32)
    lengths[-1] = max(1, T // 3)
    if NL > 2:
        lengths[1] = 0
        lengths[2:-1] = rng.integers(1, T + 1, size=NL - 3)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    return prepare_chunked(4, torch.from_numpy(chunks).to(device),
                           torch.from_numpy(lengths).to(device), t_tile=512)


def _fb_inputs(rng, NL, T, device):
    from cpgisland_tpu_torch.ops import fb_chunked
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    params = presets.durbin_cpg8(device=device)
    prep = _chunk_batch(rng, NL, T, device)
    gt = OH._groups(params)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    return params, prep, gt, a0, b0, FB.prob_tab_ext(params, gt)


@pytest.mark.parametrize("T", [8, 4099, 65536])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_fwdbwd_kernel_bit_equal(cuda_device, NL, T):
    """B4 turns FMA contraction off, so it equals its plain version bit for
    bit."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    rng = np.random.default_rng(NL * 7 + T)
    _, prep, _, a0, b0, tab = _fb_inputs(rng, NL, T, cuda_device)
    args = (prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, T)
    before = _kernels.launches["oh_fwdbwd"]
    got = FB.oh_fwdbwd(*args)
    want = FB.oh_fwdbwd_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_fwdbwd"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("T", [8, 4099, 65536])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_seq_stats_kernel_within_tolerance(cuda_device, NL, T):
    """B5 sums over time in another order than its plain version: rtol 1e-5
    on the per-lane sums, atol 1e-3 on the counts.  Random entering
    messages and pair0 masks drive the within-lane t == 0 pair as well."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(NL * 11 + T)
    params, prep, gt, a0, b0, tab = _fb_inputs(rng, NL, T, cuda_device)
    al2, b2 = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, T)
    K, S = params.n_states, params.n_symbols
    B_red = params.B[gt, torch.arange(S, device=cuda_device)[:, None]].contiguous()
    dev = lambda x: torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    enters_full = dev(rng.random((K, NL)))
    enters_red = dev(rng.random((2, NL)))
    pair0m = dev(rng.integers(0, 2, size=(1, NL)))
    args = (al2, b2, prep.pair2, prep.lens2, tab, B_red, gt.to(torch.int32).contiguous(),
            enters_full, enters_red, pair0m)
    before = _kernels.launches["oh_seq_stats"]
    got = FB.oh_seq_stats(*args, prep.Tt)
    want = FB.oh_seq_stats_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_seq_stats"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)


def test_train_file_cuda_equals_cpu(cuda_device, tmp_path):
    """Training through the kernels on the card holds against the plain
    versions on the CPU: logliks within rtol 1e-5, probabilities within
    atol 1e-5, the same iteration count."""
    rng = np.random.default_rng(5)
    p = tmp_path / "t.fa"
    with open(p, "w") as f:
        for r in range(3):
            s = rng.choice(4, size=30_000, p=[0.3, 0.2, 0.2, 0.3])
            s[9000:11000] = rng.choice(4, size=2000, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    fits = {dev: pipeline.train_file(str(p), compat=False, chunk_size=4096, num_iters=3,
                                      convergence=0.0, device=dev)
            for dev in ("cpu", "cuda")}
    a, b = fits["cpu"], fits["cuda"]
    assert a.iterations == b.iterations == 3
    np.testing.assert_allclose(a.logliks, b.logliks, rtol=1e-5)
    for x, y in ((a.params.pi, b.params.pi), (a.params.A, b.params.A),
                 (a.params.B, b.params.B)):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=1e-5)
