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


# The reduced decode's tails: bk a multiple of 8 but not of 16 or 32 (the
# backpointer chains read 32 steps ahead), lanes short of a warp or a
# block of 128 and past one.
DECODE_BK = (8, 24, 40, 4104)
DECODE_NB = (1, 33, 127, 129, 1024)
# B3 / B28's segment tails (16-word segments: 520 steps leave a 1-word last
# segment; 4,104 steps make 31 segments of 17 words, the last of 3) and B3 /
# B28's 32-lane blocks.
SEG_BK = (520, 4104)
SEG_NB = (31, 33, 65)
SEG_TAILS = [(bk, nb) for bk in SEG_BK for nb in SEG_NB
             if not (bk in DECODE_BK and nb in DECODE_NB)]
# B1 / B26 at their rows' limits (48 Ki lanes of one model, 32 Ki lanes x
# members of several) and past them (one thread a lane; B3 / B28 then take
# 32-word segments, two at 264 steps): (bk, nb) for B1, (S, M, bk, nb) for
# B26, whose members are then held against B1's rows on their own lanes.
PROD_LIMIT = [(264, 49152), (264, 49153)]
PROD_LIMIT_STACKED = [(16, 2, 264, 16384), (4, 3, 264, 16384), (16, 5, 264, 9831)]


@pytest.mark.parametrize("bk,nb", [(64, 130), (4096, 257)]
                         + [(bk, nb) for bk in DECODE_BK for nb in DECODE_NB] + SEG_TAILS
                         + PROD_LIMIT)
def test_kernels_equal_plain_versions(cuda_device, bk, nb):
    """B1, B2, B6 and B3 equal their plain versions bit for bit; one launch
    each."""
    rng = np.random.default_rng(bk + nb)
    params = presets.durbin_cpg8(device=cuda_device)
    steps = rng.integers(0, 5, size=(bk, nb)).astype(np.int32)
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01).to(cuda_device)
    steps_d = torch.from_numpy(steps).to(cuda_device)
    _, _, tab, idtab, pair2, _, _, _ = OH._prepared(params, steps_d, 1, resets)
    v = torch.from_numpy(rng.normal(size=(2, nb)).astype(np.float32)).to(cuda_device)
    bits = torch.from_numpy(rng.integers(0, 2, size=nb).astype(np.int32)).to(cuda_device)
    decode_kernels = ("oh_products", "oh_backpointers", "oh_backpointers_scores", "oh_backtrace")
    before = {k: _kernels.launches[k] for k in decode_kernels}
    assert torch.equal(OH.oh_products(pair2, tab), OH.oh_products_plain(pair2, tab))
    got = OH.oh_backpointers(pair2, v, tab)
    want = OH.oh_backpointers_scores_plain(pair2, v, tab)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:3]))
    assert all(torch.equal(a, b) for a, b in zip(OH.oh_backpointers_scores(pair2, v, tab), want))
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


@pytest.mark.parametrize("sublane_t", [None, 1 << 20, 300])
@pytest.mark.parametrize("T", [4099, 65536])
@pytest.mark.parametrize("NL", [33, 1024])
def test_fwdbwd_sublanes_bit_equal(cuda_device, monkeypatch, NL, T, sublane_t):
    """B4 at the module's sub-lane length, in one sub-lane (G = 1) and in
    many (G = 15 or 32): bit-equal to its plain version at ragged lanes,
    with non-uniform entering vectors."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    rng = np.random.default_rng(NL * 5 + T + (sublane_t or 0))
    _, prep, _, _, _, tab = _fb_inputs(rng, NL, T, cuda_device)
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((2, NL)).astype(np.float32) + 0.01).to(cuda_device)
    args = (prep.pair2, prep.pairn2, prep.lens2, v(), v(), tab, T)
    if sublane_t:
        monkeypatch.setattr(FB, "SUBLANE_T", sublane_t)
    before = _kernels.launches["oh_fwdbwd"]
    got = FB.oh_fwdbwd(*args)
    want = FB.oh_fwdbwd_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_fwdbwd"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("lane_T,sublane_t", [(100, 3), (96, 7), (8192, 512)])
def test_fwdbwd_sublanes_posterior_lanes_bit_equal(cuda_device, monkeypatch, lane_T, sublane_t):
    """B4 on a posterior span's lanes (one record cut into lanes, the last
    one short), including lanes whose last sub-lanes are empty: bit-equal
    to its plain version."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB
    from cpgisland_tpu_torch.ops.prepared import prepare_seq

    rng = np.random.default_rng(lane_T + sublane_t)
    params = presets.durbin_cpg8(device=cuda_device)
    length = 37 * lane_T - lane_T // 3
    obs = torch.from_numpy(rng.integers(0, 4, size=length).astype(np.uint8)).to(cuda_device)
    prep = prepare_seq(4, obs, length, lane_T=lane_T)
    NL = prep.pair2.shape[1]
    lens2 = prep.lane_lens[None, :].contiguous()
    tab = FB.prob_tab_ext(params, OH._groups(params))
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((2, NL)).astype(np.float32) + 0.01).to(cuda_device)
    args = (prep.pair2, prep.pairn2, lens2, v(), v(), tab, lane_T)
    monkeypatch.setattr(FB, "SUBLANE_T", sublane_t)
    assert FB.sublanes(prep.pair2.shape[0]) > 1
    got = FB.oh_fwdbwd(*args)
    want = FB.oh_fwdbwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("sublane_t", [None, 300])
@pytest.mark.parametrize("M", [2, 3])
def test_fwdbwd_stacked_sublanes_bit_equal(cuda_device, monkeypatch, M, sublane_t):
    """B24 with sub-lanes: equal to its plain version, and each member to
    its own B4 launch, bit for bit."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    NL, T = 70, 9000
    rng, _, prep, _, tabs = _stacked_batch(NL, T, 4, M, cuda_device)
    if sublane_t:
        monkeypatch.setattr(FB, "SUBLANE_T", sublane_t)
    assert FB.sublanes(prep.pair2.shape[0]) > 1
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((M, 2, NL)).astype(np.float32) + 0.01).to(cuda_device)
    args = (prep.pair2, prep.pairn2, prep.lens2, v(), v(), tabs, T)
    al, be = FB.oh_fwdbwd_stacked(*args)
    al_p, be_p = FB.oh_fwdbwd_stacked_plain(*args)
    assert torch.equal(al, al_p) and torch.equal(be, be_p)
    for m in range(M):
        a1, b1 = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, args[3][m], args[4][m],
                              tabs[m].contiguous(), T)
        assert torch.equal(a1, al[m]) and torch.equal(b1, be[m])


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
    got = FB.oh_seq_stats(*args)
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


# -- B7: the posterior's transfer products -------------------------------------


@pytest.mark.parametrize("T", [8, 4099, 8192])
@pytest.mark.parametrize("NL", [1, 33, 8192])
def test_prod_kernel_bit_equal(cuda_device, NL, T):
    """B7 writes every product, sum and division as a round-to-nearest
    intrinsic in the plain version's order: bit-equal.  Pair indices run
    past the table (PAD pairs onto the identity row) and lanes end in PAD
    tails."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    rng = np.random.default_rng(NL * 13 + T)
    params = presets.durbin_cpg8(device=cuda_device)
    pair = rng.integers(0, 16, size=(T, NL)).astype(np.int32)
    pad = rng.random((T, NL)) < 0.05
    pair[pad] = 16 + rng.integers(0, 4, size=int(pad.sum()))
    pair[T - T // 5 :, -1] = 16  # a short last lane
    pair_d = torch.from_numpy(pair).to(cuda_device)
    tab = FB.prob_tab_ext(params, OH._groups(params))
    before = _kernels.launches["oh_prod"]
    got = FB.oh_prod(pair_d, tab)
    want = FB.oh_prod_plain(pair_d, tab)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_prod"] == before + 1
    assert torch.equal(got, want)


def test_posterior_file_cuda_equals_cpu(cuda_device, tmp_path):
    """Posterior island files are byte-identical on the card and on the CPU,
    with a record long enough to run span by span and batched scaffolds;
    the confidence files agree within 1e-5."""
    rng = np.random.default_rng(9)
    p = tmp_path / "p.fa"
    with open(p, "w") as f:
        for r, n in enumerate((40_000, 3_000, 7_000, 2_500)):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            s[500:1700] = rng.choice(4, size=1200, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    outs = {}
    for dev in ("cpu", "cuda"):
        buf = io.StringIO()
        conf = tmp_path / f"c.{dev}.npy"
        pipeline.posterior_file(str(p), presets.durbin_cpg8(), islands_out=buf,
                                confidence_out=str(conf), span=1 << 14, device=dev)
        outs[dev] = (buf.getvalue(), np.load(conf))
    assert outs["cpu"][0] == outs["cuda"][0] and outs["cuda"][0]
    np.testing.assert_allclose(outs["cpu"][1], outs["cuda"][1], rtol=0, atol=1e-5)


# -- B13-B15: the dense Viterbi kernels ----------------------------------------


def _dense_operands(rng, K, bk, nb, device):
    """Seeded steps with PAD runs, a K-state model (the flagship's one-hot
    tables at K = 8, the two_state preset at K = 2, a seeded random model
    over 4 symbols at any other K), entering vectors and exit states, on
    ``device``."""
    from cpgisland_tpu_torch.ops import viterbi_pallas as VP

    if K in (2, 8):
        params = (presets.durbin_cpg8 if K == 8 else presets.two_state_cpg)(device=device)
    else:
        params = presets.random_hmm(torch.Generator().manual_seed(K), K, 4, device=device)
    S = params.n_symbols
    steps = rng.integers(0, S, size=(bk, nb)).astype(np.int32)
    for _ in range(max(1, nb // 4)):
        k0, b, n = rng.integers(0, bk), rng.integers(0, nb), rng.integers(1, 200)
        steps[k0 : k0 + n, b] = S
    v = rng.normal(scale=3.0, size=(K, nb)).astype(np.float32)
    logAT, logB = VP._tables(params)
    return (torch.from_numpy(steps).to(device), torch.from_numpy(v - v.max(0)).to(device),
            logAT, logB, torch.from_numpy(rng.integers(0, K, size=nb).astype(np.int32)).to(device))


@pytest.mark.parametrize("K,bk,nb", [(K, bk, nb) for K in (2, 8) for bk in (8, 4096)
                                     for nb in (1, 33, 4096)]
                         # B14 reads 32 steps ahead: bk short of a group, past
                         # one and past many, at every K it packs
                         + [(K, bk, nb) for K in (1, 2, 3, 5, 8) for bk in (1, 7, 9, 33, 4099)
                            for nb in (1, 33, 129)])
def test_dense_kernels_equal_plain_versions(cuda_device, K, bk, nb):
    from cpgisland_tpu_torch.ops import viterbi_pallas as VP

    steps, v, logAT, logB, exits = _dense_operands(np.random.default_rng(K * bk + nb), K, bk,
                                                   nb, cuda_device)
    names = ("dense_products", "dense_backpointers", "dense_backtrace")
    before = {k: _kernels.launches[k] for k in names}
    assert torch.equal(VP.dense_products(steps, logAT, logB),
                       VP.dense_products_plain(steps, logAT, logB))
    got = VP.dense_backpointers(steps, v, logAT, logB)
    want = VP.dense_backpointers_plain(steps, v, logAT, logB)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(VP.dense_backtrace(got[0], exits, K),
                       VP.dense_backtrace_plain(got[0], exits))
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in names)


# B15 in segments joined by exact K-state maps: lanes short of a warp, one
# short of a block of 32, the largest two_state flush's 1,024 and a 64 Mi
# record's 16,384; the decode block's 4,096 steps and ragged lengths (1,000
# and 4,097: a 1-step last segment at 128 and 256 steps, and at the kernel's
# own 128 a lane that needs 33 segments, lengthened to 129); the kernel's own
# length (seg 0) and 1 (lengthened to ceil(bk / 32)), 3 and 64 steps.
B15_GEOMETRIES = [(bk, nb) for bk in (4096, 1000, 4097) for nb in (1, 31, 1024, 16384)]


@pytest.mark.parametrize("seg", [0, 1, 3, 64])
@pytest.mark.parametrize("bk,nb", B15_GEOMETRIES)
@pytest.mark.parametrize("K", [2, 5, 8])
def test_dense_backtrace_segments_equal_plain(cuda_device, K, bk, nb, seg):
    """B15 walks each lane in segments joined by exact K-state maps: bit
    for bit the one walk's plain version, one launch a call."""
    from cpgisland_tpu_torch.ops import viterbi_pallas as VP

    steps, v, logAT, logB, exits = _dense_operands(np.random.default_rng(K * 5 + bk + nb), K,
                                                   bk, nb, cuda_device)
    bp = VP.dense_backpointers(steps, v, logAT, logB)[0]
    before = _kernels.launches["dense_backtrace"]
    path = VP.dense_backtrace(bp, exits, K, seg)
    torch.cuda.synchronize()
    assert _kernels.launches["dense_backtrace"] == before + 1
    assert torch.equal(path, VP.dense_backtrace_plain(bp, exits))


# B13 one row of the product a thread (K threads a lane, padded to a power of
# two: 16 lanes a block of 128 at K >= 5) up to 8 Ki lanes, one thread a
# lane past them, the symbols read 2, 8 or 16 steps ahead: bk short of a
# group, one past a group and past many; lanes short of a block, past one,
# the largest scaffold flush's 1,024, either side of the layouts' limit and
# the one-pass decode of a 2^28 record's 65,536.
B13_GEOMETRIES = [(7, 1), (17, 33), (33, 129), (4099, 17), (4096, 1024), (264, 8192),
                  (264, 8193), (4099, 16384), (264, 65536)]


@pytest.mark.parametrize("bk,nb", B13_GEOMETRIES)
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7, 8])
def test_dense_products_rows_equal_plain(cuda_device, K, bk, nb):
    """B13 in both of its layouts (each row of a lane's product on a
    thread of its own, or one thread a lane): bit for bit its plain
    version, PAD runs included, one launch a call."""
    from cpgisland_tpu_torch.ops import viterbi_pallas as VP

    steps, _, logAT, logB, _ = _dense_operands(np.random.default_rng(K * 7 + bk + nb), K, bk,
                                               nb, cuda_device)
    before = _kernels.launches["dense_products"]
    got = VP.dense_products(steps, logAT, logB)
    torch.cuda.synchronize()
    assert _kernels.launches["dense_products"] == before + 1
    assert torch.equal(got, VP.dense_products_plain(steps, logAT, logB))


def test_dense_decode_file_cuda_equals_cpu(cuda_device, tmp_path):
    """two_state (island_states=(0,)) and the flagship on a record that
    opens with N under mask: island files identical on the card (device
    and host island engines) and on the CPU."""
    rng = np.random.default_rng(11)
    p = tmp_path / "n.fa"
    with open(p, "w") as f:
        for r, n in enumerate((30_000, 4_000, 6_000)):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            s[900:2400] = rng.choice(4, size=1500, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "N" * 700 + "".join("ACGT"[x] for x in s) + "\n")
    cases = ((presets.two_state_cpg, {"island_states": (0,)}),
             (presets.durbin_cpg8, {"invalid_symbols": "mask"}))
    for make, kw in cases:
        outs = set()
        for dev, eng in (("cpu", "host"), ("cuda", "host"), ("cuda", "device")):
            buf = io.StringIO()
            pipeline.decode_file(str(p), make(), islands_out=buf, compat=False, device=dev,
                                 island_engine=eng, **kw)
            outs.add(buf.getvalue())
        assert len(outs) == 1 and outs.pop()


def test_device_islands_on_the_card_equal_host(cuda_device):
    from cpgisland_tpu_torch.ops import islands as H
    from cpgisland_tpu_torch.ops import islands_device as D

    rng = np.random.default_rng(5)
    parts = []
    for _ in range(400):
        parts.append(rng.integers(4, 8, size=rng.integers(1, 3000)))
        parts.append(rng.choice([1, 2, 0], size=rng.integers(1, 2000)))
    path = np.concatenate(parts).astype(np.int32)
    for block_w in (1 << 10, 1 << 22):
        cols, n = D._device_calls(torch.from_numpy(path).to(cuda_device), D.DEFAULT_CAP, None,
                                  0.5, 0.6, block_w)
        got = D._fetch_calls(cols, n, D.DEFAULT_CAP, 0, 0.5, 0.6)
        want = H.call_islands(path, compat=False)
        for k in ("beg", "end", "length", "gc_content", "oe_ratio"):
            assert np.array_equal(getattr(got, k), getattr(want, k))


# -- B16-B20: the dense forward-backward kernels --------------------------------


def _fb_dense_operands(rng, K, NL, T, device):
    """A seeded K-state model (the flagship's tables at K = 8, the
    two_state preset at K = 2), the chunked layout of [NL, T] chunks with
    ragged lengths (an empty lane and a short last lane where NL allows,
    PAD tails), and the kernels' tables on ``device``."""
    from cpgisland_tpu_torch.ops import fb_chunked
    from cpgisland_tpu_torch.ops import fb_pallas as FP
    from cpgisland_tpu_torch.ops.prepared import prepare_chunked

    params = (presets.durbin_cpg8 if K == 8 else presets.two_state_cpg)(device=device)
    S = params.n_symbols
    chunks = rng.integers(0, S, size=(NL, T)).astype(np.uint8)
    lengths = np.full(NL, T, np.int32)
    lengths[-1] = max(1, T // 3)
    if NL > 2:
        lengths[1] = 0
        lengths[2:-1] = rng.integers(1, T + 1, size=NL - 3)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(device),
                           torch.from_numpy(lengths).to(device), t_tile=512, onehot=False)
    _, a0, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    A, B, _ = FP.tables(params)
    return params, prep, A, B, a0, beta0


@pytest.mark.parametrize("K", [2, 8])
@pytest.mark.parametrize("T", [9, 4099])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_fb_dense_chain_kernels_bit_equal(cuda_device, K, NL, T):
    """B16, B18 and B19 write every product and sum as a round-to-nearest
    intrinsic in the plain version's order: bit-equal, ragged and empty
    lanes included."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    rng = np.random.default_rng(K * 1000 + NL * 7 + T)
    params, prep, A, B, a0, beta0 = _fb_dense_operands(rng, K, NL, T, cuda_device)
    names = ("fb_fwd", "fb_bwd", "fb_bwd_conf")
    before = {k: _kernels.launches[k] for k in names}
    alphas = FP.fb_fwd(prep.steps2, prep.lens2, a0, A, B)
    assert torch.equal(alphas, FP.fb_fwd_plain(prep.steps2, prep.lens2, a0, A, B))
    Tp = alphas.shape[0]
    _, steps_next, cs_next = FP.backward_inputs(prep.steps2, alphas)
    args = (steps_next, prep.lens2, cs_next, beta0)
    assert torch.equal(FP.fb_bwd(*args, A, B, T), FP.fb_bwd_plain(*args, A, B, T))
    mask = torch.from_numpy((np.arange(K) < K // 2).astype(np.float32)).to(cuda_device)
    got = FP.fb_bwd_conf(*args, alphas, mask, A, B, T)
    assert torch.equal(got, FP.fb_bwd_conf_plain(*args, alphas, mask, A, B, T))
    assert got.shape == (Tp, NL) and bool(torch.isfinite(got).all())
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in names)


@pytest.mark.parametrize("K", [2, 3, 8])
@pytest.mark.parametrize("T", [8, 4099])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_fb_dense_prod_kernel_bit_equal(cuda_device, K, NL, T):
    """B17 renormalizes after every 8th step as its plain version does, one
    thread a row with the total gathered in order: bit-equal, PAD steps
    (the identity), PAD tails and a padded row group (K = 3) included."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    rng = np.random.default_rng(K * 3000 + NL * 5 + T)
    if K == 3:
        params = presets.random_hmm(torch.Generator().manual_seed(NL + T), 3, 4,
                                    device=cuda_device)
    else:
        params = (presets.durbin_cpg8 if K == 8 else presets.two_state_cpg)(device=cuda_device)
    S = params.n_symbols
    sel = rng.integers(0, S, size=(T, NL)).astype(np.int32)
    sel[rng.random((T, NL)) < 0.05] = S
    sel[T - T // 5 :, -1] = S
    sel_d = torch.from_numpy(sel).to(cuda_device)
    A, B, _ = FP.tables(params)
    tab = FP.step_table(A, B)
    before = _kernels.launches["fb_prod"]
    got = FP.fb_prod(sel_d, tab)
    want = FP.fb_prod_plain(sel_d, tab)
    torch.cuda.synchronize()
    assert _kernels.launches["fb_prod"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("K", [2, 8])
@pytest.mark.parametrize("T", [9, 4099])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_fb_dense_stats_kernel_within_tolerance(cuda_device, K, NL, T):
    """B20 sums over time in another order than its plain version: rtol
    1e-5 and atol 1e-3 on the counts and the loglik."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    rng = np.random.default_rng(K * 5000 + NL * 3 + T)
    params, prep, A, B, a0, beta0 = _fb_dense_operands(rng, K, NL, T, cuda_device)
    alphas, _, betas = FP._run_fb_kernels(A, B, prep.steps2, prep.lens2, a0, beta0, T)
    before = _kernels.launches["fb_stats"]
    got = FP.fb_stats(alphas, betas, prep.steps2, prep.lens2, B, prep.Tt)
    want = FP.fb_stats_plain(alphas, betas, prep.steps2, prep.lens2, B)
    torch.cuda.synchronize()
    assert _kernels.launches["fb_stats"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)


def _two_state_fasta(rng, path, sizes):
    with open(path, "w") as f:
        for r, n in enumerate(sizes):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            s[900:2400] = rng.choice(4, size=1500, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    return str(path)


def test_dense_train_file_cuda_equals_cpu(cuda_device, tmp_path):
    """two_state training through B16, B18 and B20 on the card holds
    against the plain versions on the CPU: logliks within rtol 1e-5,
    probabilities within atol 1e-5; B4 and B5 never launch."""
    p = _two_state_fasta(np.random.default_rng(7), tmp_path / "t.fa", (30_000, 20_000))
    before = dict(_kernels.launches)
    fits = {dev: pipeline.train_file(p, params=presets.two_state_cpg(), compat=False,
                                      chunk_size=4096, num_iters=3, convergence=0.0, device=dev)
            for dev in ("cpu", "cuda")}
    counts = {k: _kernels.launches[k] - before[k] for k in before}
    assert counts["fb_fwd"] == counts["fb_bwd"] == counts["fb_stats"] == 3
    assert counts["oh_fwdbwd"] == counts["oh_seq_stats"] == 0
    a, b = fits["cpu"], fits["cuda"]
    np.testing.assert_allclose(a.logliks, b.logliks, rtol=1e-5)
    for x, y in ((a.params.pi, b.params.pi), (a.params.A, b.params.A),
                 (a.params.B, b.params.B)):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=1e-5)


def test_dense_posterior_file_cuda_equals_cpu(cuda_device, tmp_path):
    """two_state posterior (island_states=(0,)), span-threaded and batched:
    island files identical on the card and on the CPU, confidence within
    1e-5; a confidence-only run launches B19 and not B18."""
    p = _two_state_fasta(np.random.default_rng(13), tmp_path / "p.fa", (40_000, 3_000, 7_000))
    outs = {}
    for dev in ("cpu", "cuda"):
        buf = io.StringIO()
        conf = tmp_path / f"c.{dev}.npy"
        pipeline.posterior_file(p, presets.two_state_cpg(), islands_out=buf,
                                confidence_out=str(conf), island_states=(0,), span=1 << 14,
                                device=dev)
        outs[dev] = (buf.getvalue(), np.load(conf))
    assert outs["cpu"][0] == outs["cuda"][0] and outs["cuda"][0]
    np.testing.assert_allclose(outs["cpu"][1], outs["cuda"][1], rtol=0, atol=1e-5)
    before = dict(_kernels.launches)
    pipeline.posterior_file(p, presets.two_state_cpg(), confidence_out=str(tmp_path / "c.npy"),
                            island_states=(0,), device="cuda")
    assert _kernels.launches["fb_bwd_conf"] > before["fb_bwd_conf"]
    assert _kernels.launches["fb_bwd"] == before["fb_bwd"]


# -- B21, B24, B25: the stacked kernels; the scoring kernels -------------------


def _stacked_batch(NL, T, S, M, device):
    """M members of one alphabet (the flagship at S = 4, dinuc_cpg at S =
    16, plus random partition=2 members) over one seeded [NL, T] chunk
    batch: ragged lengths, an empty lane where NL allows, PAD tails; pair
    recoded (so consecutive pairs chain) at S = 16."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB
    from cpgisland_tpu_torch.ops.prepared import prepare_chunked
    from cpgisland_tpu_torch.utils.codec import recode_pairs

    rng = np.random.default_rng(NL * 31 + T + 7 * M + S)
    gen = torch.Generator().manual_seed(NL + M + S)
    first = presets.durbin_cpg8(device=device) if S == 4 else presets.dinuc_cpg(device=device)
    members = [first] + [presets.random_hmm(gen, 2 * S, S, partition=2, device=device)
                         for _ in range(M - 1)]
    chunks = rng.integers(0, 4, size=(NL, T)).astype(np.uint8)
    if S == 16:
        chunks = recode_pairs(chunks.ravel()).reshape(NL, T)
    lengths = np.full(NL, T, np.int32)
    lengths[-1] = max(1, T // 3)
    if NL > 2:
        lengths[1] = 0
        lengths[2:-1] = rng.integers(1, T + 1, size=NL - 3)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(device),
                           torch.from_numpy(lengths).to(device), t_tile=512)
    gts, tabs = FB.stacked_tables(members)
    return rng, members, prep, gts, tabs


_STACK_GRID = pytest.mark.parametrize("S", [4, 16])
_STACK_M = pytest.mark.parametrize("M", [1, 2, 5])
_STACK_NL = pytest.mark.parametrize("NL", [1, 33, 1024])


@_STACK_GRID
@_STACK_M
@_STACK_NL
def test_prod_stacked_kernel_bit_equal(cuda_device, NL, M, S):
    """B21 equals its plain version, and each member's slice equals B7 on
    that member's table, bit for bit."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    _, _, prep, _, tabs = _stacked_batch(NL, 2000, S, M, cuda_device)
    before = _kernels.launches["oh_prod_stacked"]
    got = FB.oh_prod_stacked(prep.pair2, tabs)
    assert _kernels.launches["oh_prod_stacked"] == before + 1
    assert torch.equal(got, FB.oh_prod_stacked_plain(prep.pair2, tabs))
    for m in range(M):
        assert torch.equal(got[m], FB.oh_prod(prep.pair2, tabs[m].contiguous()))


@_STACK_GRID
@_STACK_M
@_STACK_NL
def test_fwdbwd_stacked_kernel_bit_equal(cuda_device, NL, M, S):
    """B24 equals its plain version, and each member's chains equal B4's on
    that member's operands, bit for bit."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    T = 2000
    rng, _, prep, _, tabs = _stacked_batch(NL, T, S, M, cuda_device)
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((M, 2, NL)).astype(np.float32) + 0.01).to(cuda_device)
    args = (prep.pair2, prep.pairn2, prep.lens2, v(), v(), tabs, T)
    before = _kernels.launches["oh_fwdbwd_stacked"]
    al, be = FB.oh_fwdbwd_stacked(*args)
    assert _kernels.launches["oh_fwdbwd_stacked"] == before + 1
    al_p, be_p = FB.oh_fwdbwd_stacked_plain(*args)
    assert torch.equal(al, al_p) and torch.equal(be, be_p)
    for m in range(M):
        a1, b1 = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, args[3][m], args[4][m],
                              tabs[m].contiguous(), T)
        assert torch.equal(a1, al[m]) and torch.equal(b1, be[m])


@_STACK_GRID
@_STACK_M
@_STACK_NL
def test_seq_stats_stacked_kernel(cuda_device, NL, M, S):
    """B25 within B5's tolerance of its plain version (rtol 1e-5 / atol
    1e-3), and each member's counts equal B5's bit for bit (the same body
    on the same operands); random entering messages and pair0 masks."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    T = 2000
    rng, members, prep, gts, tabs = _stacked_batch(NL, T, S, M, cuda_device)
    K = 2 * S
    v = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.random(shape).astype(np.float32) + 0.01).to(cuda_device)
    al, be = FB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, v(M, 2, NL),
                                  v(M, 2, NL), tabs, T)
    B_reds = torch.stack([FB.reduced_emissions(p, gt) for p, gt in zip(members, gts)])
    gts32 = gts.to(torch.int32).contiguous()
    pair0m = torch.from_numpy(rng.integers(0, 2, size=(1, NL)).astype(np.float32)).to(cuda_device)
    args = (al, be, prep.pair2, prep.lens2, tabs, B_reds, gts32, v(M, K, NL), v(M, 2, NL),
            pair0m)
    before = _kernels.launches["oh_seq_stats_stacked"]
    got = FB.oh_seq_stats_stacked(*args)
    assert _kernels.launches["oh_seq_stats_stacked"] == before + 1
    for g, w in zip(got, FB.oh_seq_stats_stacked_plain(*args)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)
    for m in range(M):
        single = FB.oh_seq_stats(al[m], be[m], prep.pair2, prep.lens2, tabs[m].contiguous(),
                                 B_reds[m], gts32[m], args[7][m], args[8][m], pair0m)
        assert all(torch.equal(a, b[m]) for a, b in zip(single, got))


@_STACK_GRID
@_STACK_M
@_STACK_NL
def test_reduced_scoring_kernel(cuda_device, NL, M, S):
    """The reduced scoring chain: per-lane float64 sums within 1e-12 of its
    plain version (the float32 chain is bit-equal; only the float64 log
    may round differently), each member equal to its own M = 1 launch."""
    from cpgisland_tpu_torch.ops import loglik as LL

    rng, _, prep, _, tabs = _stacked_batch(NL, 2000, S, M, cuda_device)
    e = rng.random((M, 2, NL)).astype(np.float32) + 0.01
    enter = torch.from_numpy(e / e.sum(axis=1, keepdims=True)).to(cuda_device)
    before = _kernels.launches["oh_loglik"]
    got = LL.oh_loglik(prep.pair2, enter, tabs)
    assert _kernels.launches["oh_loglik"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               LL.oh_loglik_plain(prep.pair2, enter, tabs).cpu().numpy(),
                               rtol=1e-12)
    for m in range(M):
        one = LL.oh_loglik(prep.pair2, enter[m : m + 1], tabs[m : m + 1].contiguous())
        assert torch.equal(one[0], got[m])


@pytest.mark.parametrize("model", ["two_state", "null4", "null16", "durbin8"])
@_STACK_NL
def test_dense_scoring_kernel(cuda_device, NL, model):
    """The dense scoring chain (K = 2, 1, 1, 8) against its plain version on
    a symbol stream with PADs and a PAD tail: within 1e-12 per lane."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP
    from cpgisland_tpu_torch.ops import loglik as LL

    params = {"two_state": lambda: presets.two_state_cpg(device=cuda_device),
              "null4": lambda: presets.null_background(4, device=cuda_device),
              "null16": lambda: presets.null_background(16, device=cuda_device),
              "durbin8": lambda: presets.durbin_cpg8(device=cuda_device)}[model]()
    K, S = params.n_states, params.n_symbols
    rng = np.random.default_rng(NL + K + S)
    sel = rng.integers(0, S, size=(2000, NL)).astype(np.int32)
    sel[rng.random(sel.shape) < 0.05] = S
    sel[1500:, -1] = S
    e = rng.random((K, NL)).astype(np.float32) + 0.01
    enter = torch.from_numpy(e / e.sum(axis=0)).to(cuda_device)
    A, B, _ = FP.tables(params)
    sel_d = torch.from_numpy(sel).to(cuda_device)
    before = _kernels.launches["fb_loglik"]
    got = LL.fb_loglik(sel_d, enter, A, B)
    assert _kernels.launches["fb_loglik"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               LL.fb_loglik_plain(sel_d, enter, A, B).cpu().numpy(), rtol=1e-12)


def test_compare_file_cuda_equals_cpu(cuda_device, tmp_path):
    """The compare report of a mixed cast with a stacked group: record and
    winner-track lines byte-identical on the card and on the CPU, each
    model line's loglik and log-odds within 1e-6 of the loglik (the models'
    probability tables are exp of their log tables on each device, which
    rounds an ulp apart); the card's stacked run launches B21 and B24 and
    no B7 or B4."""
    from cpgisland_tpu_torch import family

    gen = torch.Generator().manual_seed(3)
    members = [family.builtin_member("durbin8"),
               family.member_from_params("rand", presets.random_hmm(gen, 8, 4, partition=2)),
               family.builtin_member("two_state"), family.builtin_member("null")]
    rng = np.random.default_rng(21)
    p = tmp_path / "c.fa"
    with open(p, "w") as f:
        for r, n in enumerate((12_000, 3_000, 7_000)):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            s[500:1700] = rng.choice(4, size=1200, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    outs = {}
    for dev in ("cpu", "cuda"):
        buf = io.StringIO()
        _kernels.reset_launches()
        pipeline.compare_file(str(p), members, out=buf, device=dev)
        outs[dev] = buf.getvalue().splitlines()
    assert _kernels.launches["oh_prod_stacked"] and _kernels.launches["oh_fwdbwd_stacked"]
    assert _kernels.launches["oh_prod"] == _kernels.launches["oh_fwdbwd"] == 0
    assert len(outs["cpu"]) == len(outs["cuda"])
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not a.startswith("# model "):
            assert a == b
            continue
        a, b = a.split(), b.split()
        assert a[:4] + a[7:] == b[:4] + b[7:]
        for i in (4, 6):
            assert abs(float(a[i]) - float(b[i])) <= 1e-6 * abs(float(a[4]))


def test_fit_family_cuda_equals_solo_fits(cuda_device):
    """fit_family on the card: B24 and B25 once per iteration, no B4 or B5,
    and every member's trajectory and model equal to its own fit on the
    card, bit for bit."""
    from cpgisland_tpu_torch.train import baum_welch
    from cpgisland_tpu_torch.train.backends import fit_family
    from cpgisland_tpu_torch.utils import chunking

    gen = torch.Generator().manual_seed(4)
    members = [presets.durbin_cpg8(device=cuda_device)] + [
        presets.random_hmm(gen, 8, 4, partition=2, device=cuda_device) for _ in range(2)]
    rng = np.random.default_rng(8)
    s = rng.choice(4, size=40_000, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    chunked = chunking.frame(s, 4096)
    _kernels.reset_launches()
    fitted, hist = fit_family(members, chunked.chunks, chunked.lengths, n_iter=3)
    assert _kernels.launches["oh_fwdbwd_stacked"] == _kernels.launches["oh_seq_stats_stacked"] == 3
    assert _kernels.launches["oh_fwdbwd"] == _kernels.launches["oh_seq_stats"] == 0
    for m, p in enumerate(members):
        solo = baum_welch.fit(p, chunked, num_iters=3, convergence=0.0, engine="onehot")
        np.testing.assert_array_equal(hist[:, m], np.asarray(solo.logliks))
        for f in ("log_pi", "log_A", "log_B"):
            assert torch.equal(getattr(fitted[m], f), getattr(solo.params, f))


@pytest.mark.parametrize("n_chunks", [1390, 1391])
def test_family_estep_cuda_equals_local_backend(cuda_device, n_chunks):
    """One stacked E-step at a training batch's lane count (an odd one
    too, so a member's slice of the stacked outputs starts off a 16-byte
    boundary): every member's statistics equal LocalBackend(engine="onehot")
    on the card bit for bit."""
    from cpgisland_tpu_torch.train.backends import FamilyEStep, LocalBackend
    from cpgisland_tpu_torch.utils import chunking

    gen = torch.Generator().manual_seed(6)
    members = [presets.durbin_cpg8(device=cuda_device)] + [
        presets.random_hmm(gen, 8, 4, partition=2, device=cuda_device) for _ in range(2)]
    rng = np.random.default_rng(n_chunks)
    chunked = chunking.frame(rng.integers(0, 4, size=n_chunks * 512 - 100).astype(np.uint8), 512)
    estep = FamilyEStep()
    chunks, lengths = estep.place(chunked.chunks, chunked.lengths, cuda_device)
    got = estep(members, chunks, lengths)
    for p, g in zip(members, got):
        backend = LocalBackend(engine="onehot")
        want = backend(p, chunks, lengths, prepared=backend.prepare_streams(p, chunks, lengths))
        for f in ("init", "trans", "emit", "loglik", "n_seqs"):
            assert torch.equal(getattr(g, f), getattr(want, f)), f


# -- B6, the span-wise decode and the posterior's device islands ---------------


@pytest.mark.parametrize("bk,nb", [(8, 1), (64, 130), (4096, 257)])
def test_scores_kernel_equals_plain_and_b2(cuda_device, bk, nb):
    """B6 equals its plain version bit for bit on every output (dmax2
    included) over a reset-renumbered stream, and its bp, dexit and ebits
    equal B2's launch on the same input."""
    rng = np.random.default_rng(7 * bk + nb)
    params = presets.durbin_cpg8(device=cuda_device)
    steps = rng.integers(0, 5, size=(bk, nb)).astype(np.int32)
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01).to(cuda_device)
    _, _, tab, _, pair2, _, _, nreal = OH._prepared(params, torch.from_numpy(steps).to(cuda_device),
                                                    1, resets)
    assert tab.shape[0] == 24 and nreal == 20  # S*S real, S reset and S PAD rows
    v = torch.from_numpy(rng.normal(size=(2, nb)).astype(np.float32)).to(cuda_device)
    before = _kernels.launches["oh_backpointers_scores"]
    got = OH.oh_backpointers_scores(pair2, v, tab.contiguous())
    want = OH.oh_backpointers_scores_plain(pair2, v, tab)
    b2 = OH.oh_backpointers(pair2, v, tab.contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got[:3], b2))
    assert _kernels.launches["oh_backpointers_scores"] == before + 1


def test_flat_batch_scores_cuda_equals_cpu(cuda_device):
    """viterbi_parallel_batch(engine="onehot") on the card through B6: paths
    and scores equal the CPU's (plain versions) bit for bit, and each score
    lies within 1e-3 * N * T of the record's own viterbi_parallel score."""
    from cpgisland_tpu_torch.ops import viterbi_parallel as VPL

    rng = np.random.default_rng(12)
    N, T = 6, 3000
    chunks = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    chunks[1, 700:760] = 4
    lengths = np.array([3000, 2000, 2, 2999, 1500, 3000], np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        params = presets.durbin_cpg8(device=dev)
        before = _kernels.launches["oh_backpointers_scores"]
        out[dev] = VPL.viterbi_parallel_batch(params, torch.from_numpy(chunks).to(dev),
                                              torch.from_numpy(lengths).to(dev), block_size=512)
        assert _kernels.launches["oh_backpointers_scores"] == before + (dev == "cuda")
    (pc, sc), (pg, sg) = out["cpu"], out["cuda"]
    assert torch.equal(pc, pg.cpu()) and torch.equal(sc, sg.cpu())
    params = presets.durbin_cpg8(device=cuda_device)
    for i in range(N):
        o = np.where(np.arange(T) >= lengths[i], 4, chunks[i]).astype(np.int32)
        _, s = VPL.viterbi_parallel(params, torch.from_numpy(o).to(cuda_device), block_size=512)
        assert abs(float(sg[i]) - float(s)) <= 1e-3 * N * T


@pytest.mark.parametrize("make", [presets.durbin_cpg8, presets.two_state_cpg])
def test_spanwise_decode_on_the_card(cuda_device, make):
    """viterbi_sharded_spans on the card equals its one-shot decode and the
    CPU's span-wise decode bit for bit (6 spans, a ragged tail)."""
    from cpgisland_tpu_torch.parallel import decode as PD

    rng = np.random.default_rng(21)
    obs = rng.choice([0, 3], size=5 * 65536 + 777).astype(np.uint8)
    for mid in (65536, 2 * 65536):
        obs[mid - 300 : mid + 300] = np.tile([1, 2], 300)
    obs[3 * 65536 - 40 : 3 * 65536 + 70] = 4
    params = make(device=cuda_device)
    spans = PD.viterbi_sharded_spans(params, obs, span=65536, block_size=1024)
    one = PD.viterbi_sharded(params, obs, block_size=1024)
    cpu = PD.viterbi_sharded_spans(make(), obs, span=65536, block_size=1024)
    assert np.array_equal(np.concatenate(spans), one)
    assert np.array_equal(np.concatenate(spans), np.concatenate(cpu))


def test_posterior_device_islands_on_the_card(cuda_device, tmp_path):
    """posterior_file on the card: the device island engine (one record, a
    batch, a 3-span record) writes the host engine's file and the CPU's."""
    rng = np.random.default_rng(31)
    p = tmp_path / "x.fa"
    with open(p, "w") as f:
        for r, n in enumerate((3000, 90000, 5200, 1300, 20000)):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            for a in range(500, n - 1000, 6000):
                s[a : a + 900] = rng.choice(4, size=900, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    outs = set()
    for make, states in ((presets.durbin_cpg8, None), (presets.two_state_cpg, (0,))):
        for dev, eng in (("cpu", "host"), ("cuda", "host"), ("cuda", "device")):
            buf = io.StringIO()
            pipeline.posterior_file(str(p), make(), islands_out=buf, island_states=states,
                                    span=1 << 15, island_engine=eng, device=dev)
            outs.add((make.__name__, buf.getvalue()))
        assert len([o for o in outs if o[0] == make.__name__]) == 1


# -- B8 (the one-pass arm) and whole-sequence training ---------------------------


@pytest.mark.parametrize("T", [8, 1237, 8192])
@pytest.mark.parametrize("NL", [1, 33, 4096])
def test_fwdbwd_mat_kernel_bit_equal(cuda_device, NL, T):
    """B8 carries both chains as 2x2 matrices with every product, sum and
    division a round-to-nearest intrinsic in the plain version's order:
    bit-equal.  Ragged lane lengths, empty lanes, PAD pairs."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    rng = np.random.default_rng(NL * 7 + T)
    params = presets.durbin_cpg8(device=cuda_device)
    pair = rng.integers(0, 16, size=(T, NL)).astype(np.int32)
    pad = rng.random((T, NL)) < 0.05
    pair[pad] = 16 + rng.integers(0, 4, size=int(pad.sum()))
    pairn = np.concatenate([pair[1:], np.full((1, NL), 16, np.int32)])
    lens = rng.integers(0, T + 1, size=(1, NL)).astype(np.int32)
    lens[0, 0] = T
    d = lambda x: torch.from_numpy(x).to(cuda_device)
    tab = FB.prob_tab_ext(params, OH._groups(params))
    args = (d(pair), d(pairn), d(lens), tab, T)
    before = _kernels.launches["oh_fwdbwd_mat"]
    got = FB.oh_fwdbwd_mat(*args)
    want = FB.oh_fwdbwd_mat_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_fwdbwd_mat"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("backend", ["seq", "seq_one_pass", "seq2d"])
def test_seq_training_cuda_equals_cpu(cuda_device, tmp_path, backend):
    """Whole-sequence training on the card (the kernels) holds against the
    plain versions on the CPU (logliks rtol 1e-5, probabilities atol
    1e-5), and the device loop equals the host loop bit for bit there."""
    from cpgisland_tpu_torch.train.backends import SeqBackend

    rng = np.random.default_rng(8)
    p = tmp_path / "t.fa"
    with open(p, "w") as f:
        for r, n in enumerate((70_000, 9_000)):
            s = rng.choice(4, size=n, p=[0.3, 0.2, 0.2, 0.3])
            s[5000:7000] = rng.choice(4, size=2000, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    make = {"seq": lambda: "seq", "seq_one_pass": lambda: SeqBackend(one_pass=True),
            "seq2d": lambda: "seq2d"}[backend]
    fits = {(dev, fuse): pipeline.train_file(str(p), compat=False, num_iters=3,
                                              convergence=0.0, backend=make(), fuse=fuse,
                                              device=dev)
            for dev, fuse in (("cpu", "on"), ("cuda", "on"), ("cuda", "off"))}
    a, b, c = fits["cpu", "on"], fits["cuda", "on"], fits["cuda", "off"]
    assert a.iterations == b.iterations == 3
    np.testing.assert_allclose(a.logliks, b.logliks, rtol=1e-5)
    for x, y in ((a.params.pi, b.params.pi), (a.params.A, b.params.A),
                 (a.params.B, b.params.B)):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=1e-5)
    assert b.logliks == c.logliks and b.deltas == c.deltas
    assert all(torch.equal(x, y) for x, y in ((b.params.log_A, c.params.log_A),
                                              (b.params.log_B, c.params.log_B),
                                              (b.params.log_pi, c.params.log_pi)))


# -- B9-B12, B22, B23: the split arm ---------------------------------------------


def _split_args(rng, NL, T, device):
    """B9's inputs at a ragged chunked geometry, its alphas and B10's
    cs_next from them."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    params, prep, gt, a0, b0, tab = _fb_inputs(rng, NL, T, device)
    al = FB.oh_fwd(prep.pair2, prep.lens2, a0, tab)
    return params, prep, gt, a0, b0, tab, al, FB.cs_next_of(al)


@pytest.mark.parametrize("T", [8, 4099, 65536])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_split_chain_kernels_bit_equal(cuda_device, monkeypatch, NL, T):
    """B9, B10 and B11 turn FMA contraction off: each equals its plain
    version bit for bit, and B9's alphas equal B4's (B9 runs in B4's
    sub-lanes)."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    rng = np.random.default_rng(NL * 13 + T)
    before = {k: _kernels.launches[k] for k in ("oh_fwd", "oh_bwd", "oh_bwd_conf")}
    _, prep, gt, a0, b0, tab, al, cs_next = _split_args(rng, NL, T, cuda_device)
    assert torch.equal(al, FB.oh_fwd_plain(prep.pair2, prep.lens2, a0, tab))
    al4, _ = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, T)
    assert torch.equal(al, al4)
    bargs = (prep.pairn2, prep.lens2, cs_next, b0, tab, T)
    assert torch.equal(FB.oh_bwd(*bargs), FB.oh_bwd_plain(*bargs))
    mtab = torch.from_numpy(rng.integers(0, 2, size=(4, 2)).astype(np.float32)).to(cuda_device)
    cargs = (prep.pairn2, prep.pair2, prep.lens2, cs_next, b0, al, mtab, tab, T)
    assert torch.equal(FB.oh_bwd_conf(*cargs), FB.oh_bwd_conf_plain(*cargs))
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in before)


@pytest.mark.parametrize("T", [8, 4099, 65536])
@pytest.mark.parametrize("NL", [1, 33, 1024])
def test_stats_kernel_within_tolerance(cuda_device, NL, T):
    """B12 sums over time in another order than its plain version: rtol
    1e-5 on the per-lane sums, atol 1e-3 on the counts."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(NL * 17 + T)
    params, prep, gt, a0, b0, tab, al, cs_next = _split_args(rng, NL, T, cuda_device)
    be = FB.oh_bwd(prep.pairn2, prep.lens2, cs_next, b0, tab, T)
    args = (al, be, prep.pair2, prep.lens2, FB.reduced_emissions(params, gt),
            gt.to(torch.int32).contiguous())
    before = _kernels.launches["oh_stats"]
    got = FB.oh_stats(*args)
    want = FB.oh_stats_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_stats"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)


def _split_model_batch(S, NL, T, device):
    """One reduced model of S symbols (a random partition=2 model at S = 2,
    the flagship at 4, dinuc_cpg at 16) over a seeded [NL, T] chunk batch
    (ragged, an empty lane where NL allows, PAD tails; pairs recoded at S =
    16), and its split arm's streams: (params, prep, gt, alphas, betas)."""
    from cpgisland_tpu_torch.ops import fb_chunked
    from cpgisland_tpu_torch.ops import fb_onehot as FB
    from cpgisland_tpu_torch.ops.prepared import prepare_chunked
    from cpgisland_tpu_torch.utils.codec import recode_pairs

    rng = np.random.default_rng(S * 101 + NL + T)
    if S == 2:
        params = presets.random_hmm(torch.Generator().manual_seed(NL + T), 4, 2, partition=2,
                                    device=device)
    else:
        params = (presets.durbin_cpg8 if S == 4 else presets.dinuc_cpg)(device=device)
    chunks = rng.integers(0, min(S, 4), size=(NL, T)).astype(np.uint8)
    if S == 16:
        chunks = recode_pairs(chunks.ravel()).reshape(NL, T)
    lengths = np.full(NL, T, np.int32)
    lengths[-1] = max(1, T // 3)
    if NL > 2:
        lengths[1] = 0
        lengths[2:-1] = rng.integers(1, T + 1, size=NL - 3)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = S
    prep = prepare_chunked(S, torch.from_numpy(chunks).to(device),
                           torch.from_numpy(lengths).to(device), t_tile=512)
    gt = OH._groups(params)
    tab = FB.prob_tab_ext(params, gt)
    _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(params, prep)
    a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
    b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
    al = FB.oh_fwd(prep.pair2, prep.lens2, a0, tab)
    be = FB.oh_bwd(prep.pairn2, prep.lens2, FB.cs_next_of(al), b0, tab, T)
    return params, prep, gt, al, be


# B12 in B5's layout: Tp below one 512-step segment, past one and not a
# multiple of it; NL short of a block's 32 lanes and past one.
@pytest.mark.parametrize("NL,T", [(33, 300), (33, 4099), (1, 4099), (40, 1100)])
@pytest.mark.parametrize("S", [2, 4, 16])
def test_stats_kernel_in_seq_stats_layout(cuda_device, S, NL, T):
    """B12 through B5's part and reduce kernels (32 lanes x
    stats_segments_per_block segments a block: 4, or 1 at S = 16): within
    rtol 1e-5 / atol 1e-3 of its plain version, two launches the same bits
    (no atomics), one launch a call."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    params, prep, gt, al, be = _split_model_batch(S, NL, T, cuda_device)
    args = (al, be, prep.pair2, prep.lens2, FB.reduced_emissions(params, gt),
            gt.to(torch.int32).contiguous())
    before = _kernels.launches["oh_stats"]
    got, again = FB.oh_stats(*args), FB.oh_stats(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_stats"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, FB.oh_stats_plain(*args)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)


def test_split_stacked_member_equals_single_launch(cuda_device):
    """``batch_stats_stacked(fused=False)`` (B22, B23, then B12 per member)
    gives every member the stats of its own split-arm ``batch_stats`` on
    the card bit for bit: both run B12 on the same streams."""
    from cpgisland_tpu_torch.ops import fb_chunked

    M, NL, T = 3, 33, 4099
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)
    members = [presets.durbin_cpg8(device=cuda_device)] + [
        presets.random_hmm(gen, 8, 4, partition=2, device=cuda_device) for _ in range(M - 1)]
    chunks = rng.integers(0, 4, size=(NL, T)).astype(np.uint8)
    lengths = rng.integers(0, T + 1, size=NL).astype(np.int32)
    chunks[np.arange(T)[None, :] >= lengths[:, None]] = 4
    chunks = torch.from_numpy(chunks).to(cuda_device)
    lengths = torch.from_numpy(lengths).to(cuda_device)
    before = _kernels.launches["oh_stats"]
    stacked = fb_chunked.batch_stats_stacked(members, chunks, lengths, fused=False)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_stats"] == before + M
    for p, got in zip(members, stacked):
        own = fb_chunked.batch_stats(p, chunks, lengths, fused=False)
        for f in ("init", "trans", "emit", "loglik", "n_seqs"):
            assert torch.equal(getattr(got, f), getattr(own, f)), f


@_STACK_GRID
@_STACK_M
@_STACK_NL
def test_split_stacked_kernels_bit_equal(cuda_device, NL, M, S):
    """B22 and B23 equal their plain versions, and each member's chains
    equal B9's and B10's on that member's operands, bit for bit."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    T = 2000
    rng, _, prep, _, tabs = _stacked_batch(NL, T, S, M, cuda_device)
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((M, 2, NL)).astype(np.float32) + 0.01).to(cuda_device)
    a0, b0 = v(), v()
    before = {k: _kernels.launches[k] for k in ("oh_fwd_stacked", "oh_bwd_stacked")}
    al = FB.oh_fwd_stacked(prep.pair2, prep.lens2, a0, tabs)
    cs_next = FB.cs_next_of(al)
    be = FB.oh_bwd_stacked(prep.pairn2, prep.lens2, cs_next, b0, tabs, T)
    assert all(_kernels.launches[k] == before[k] + 1 for k in before)
    assert torch.equal(al, FB.oh_fwd_stacked_plain(prep.pair2, prep.lens2, a0, tabs))
    assert torch.equal(be, FB.oh_bwd_stacked_plain(prep.pairn2, prep.lens2, cs_next, b0,
                                                   tabs, T))
    for m in range(M):
        tab = tabs[m].contiguous()
        assert torch.equal(al[m], FB.oh_fwd(prep.pair2, prep.lens2, a0[m], tab))
        assert torch.equal(be[m], FB.oh_bwd(prep.pairn2, prep.lens2, cs_next[m], b0[m], tab, T))


def test_split_training_cuda_equals_cpu(cuda_device, tmp_path):
    """``LocalBackend(fuse_fb=False)`` on the card (B9, B10, B12, never B4
    or B5) holds against the plain versions on the CPU (logliks rtol 1e-5,
    probabilities atol 1e-5) and against the card's fused arm (logliks rtol
    1e-5)."""
    from cpgisland_tpu_torch.train.backends import LocalBackend

    rng = np.random.default_rng(9)
    p = tmp_path / "t.fa"
    with open(p, "w") as f:
        s = rng.choice(4, size=140_000, p=[0.3, 0.2, 0.2, 0.3])
        s[5000:7000] = rng.choice(4, size=2000, p=[0.15, 0.35, 0.35, 0.15])
        f.write(">r0\n" + "".join("ACGT"[x] for x in s) + "\n")
    kw = dict(compat=False, num_iters=3, convergence=0.0)
    cpu = pipeline.train_file(str(p), backend=LocalBackend(fuse_fb=False), device="cpu", **kw)
    _kernels.reset_launches()
    card = pipeline.train_file(str(p), backend=LocalBackend(fuse_fb=False), device="cuda", **kw)
    counts = dict(_kernels.launches)
    fused = pipeline.train_file(str(p), device="cuda", **kw)
    assert counts["oh_fwd"] == counts["oh_bwd"] == counts["oh_stats"] == 3
    assert counts["oh_fwdbwd"] == counts["oh_seq_stats"] == 0
    np.testing.assert_allclose(cpu.logliks, card.logliks, rtol=1e-5)
    np.testing.assert_allclose(card.logliks, fused.logliks, rtol=1e-5)
    for x, y in ((cpu.params.pi, card.params.pi), (cpu.params.A, card.params.A),
                 (cpu.params.B, card.params.B)):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=1e-5)


# -- B26-B28: the stacked decode; B1, B6 and B3 at 16 symbols -----------------


def _decode_members(S, M, device, seed=0):
    """The flagship (S = 4) or dinuc_cpg (S = 16) plus M - 1 random
    partition=2 members of its alphabet, their states scrambled (so each
    member has its own groups and exit anchors)."""
    from cpgisland_tpu_torch.models.hmm import HmmParams

    gen = torch.Generator().manual_seed(seed + 17 * M + S)
    first = presets.durbin_cpg8(device=device) if S == 4 else presets.dinuc_cpg(device=device)
    out = [first]
    for _ in range(M - 1):
        p = presets.random_hmm(gen, 2 * S, S, partition=2, device=device)
        perm = torch.randperm(2 * S, generator=gen).to(device)  # scrambled groups
        out.append(HmmParams(p.log_pi[perm], p.log_A[perm][:, perm], p.log_B[perm]))
    return out


def _decode_symbols(rng, S, shape):
    """Random symbols; pair recodes of random bases (which chain) at S = 16."""
    from cpgisland_tpu_torch.utils.codec import recode_pairs

    base = rng.integers(0, 4, size=shape).astype(np.uint8)
    return base if S == 4 else recode_pairs(base.ravel()).reshape(shape)


STACKED_DECODE = ("oh_products_stacked", "oh_backpointers_stacked",
                  "oh_backpointers_stacked_scores", "oh_backtrace_stacked")


@pytest.mark.parametrize("S,M,bk,nb", [(4, 1, 8, 1), (4, 2, 64, 130), (4, 5, 512, 300),
                                       (16, 2, 128, 257), (16, 3, 4096, 129)]
                         # every tail at each (S, M), every pair of them at (4, 2)
                         + [(S, M, bk, nb) for S in (4, 16) for M in (1, 2, 5)
                            for bk, nb in zip(DECODE_BK + (40,), DECODE_NB[::-1])
                            if (S, M) != (4, 2)]
                         + [(4, 2, bk, nb) for bk in DECODE_BK for nb in DECODE_NB]
                         # the segment tails at every (S, M)
                         + [(S, M, bk, nb) for S in (4, 16) for M in (1, 2, 5)
                            for bk, nb in SEG_TAILS] + PROD_LIMIT_STACKED)
def test_stacked_decode_kernels_equal_plain_and_single(cuda_device, S, M, bk, nb):
    """B26, B27 (both arms) and B28 equal their plain versions bit for bit
    over a reset-renumbered stream with PAD runs, and each member's slice
    equals B1 / B2 / B6 / B3 on its own operands; one launch each."""
    rng = np.random.default_rng(S * 1000 + M * 100 + nb)
    members = _decode_members(S, M, cuda_device)
    steps = _decode_symbols(rng, S, (nb, bk)).T.astype(np.int32).copy()
    steps[rng.random((bk, nb)) < 0.02] = S
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01).to(cuda_device)
    _, _, tabs, idtabs, pair2, _, _, nreal = OH.stacked_prepared(
        members, torch.from_numpy(steps).to(cuda_device), int(steps[0, 0]) % S, resets)
    tabs, idtabs = torch.stack(tabs), torch.stack(idtabs)
    assert tabs.shape == (M, S * S + 2 * S, 4) and nreal == S * S + S
    v = torch.from_numpy(rng.normal(size=(M, 2, nb)).astype(np.float32)).to(cuda_device)
    bits = torch.from_numpy(rng.integers(0, 2, size=(M, nb)).astype(np.int32)).to(cuda_device)
    before = {k: _kernels.launches[k] for k in STACKED_DECODE}
    red = OH.oh_products_stacked(pair2, tabs)
    bpw = OH.oh_backpointers_stacked(pair2, v, tabs)
    sc = OH.oh_backpointers_stacked_scores(pair2, v, tabs)
    path = OH.oh_backtrace_stacked(sc[0], pair2, idtabs, bits)
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in STACKED_DECODE)
    assert torch.equal(red, OH.oh_products_stacked_plain(pair2, tabs))
    want = OH.oh_backpointers_stacked_scores_plain(pair2, v, tabs)
    assert all(torch.equal(a, b) for a, b in zip(sc, want))
    assert all(torch.equal(a, b) for a, b in zip(bpw, want[:3]))
    assert torch.equal(path, OH.oh_backtrace_stacked_plain(want[0], pair2, idtabs, bits))
    for m in range(M):
        assert torch.equal(OH.oh_products(pair2, tabs[m]), red[m])
        single = OH.oh_backpointers_scores(pair2, v[m].contiguous(), tabs[m])
        assert all(torch.equal(a, b[m]) for a, b in zip(single, sc))
        assert all(torch.equal(a, b[m]) for a, b in zip(
            OH.oh_backpointers(pair2, v[m].contiguous(), tabs[m]), bpw))
        assert torch.equal(OH.oh_backtrace(sc[0][m].contiguous(), pair2, idtabs[m],
                                           bits[m].contiguous()), path[m])


def test_dinuc_flat_decode_kernels_equal_plain(cuda_device, monkeypatch):
    """The repair: a dinuc_cpg flat batch (288-row tables) decodes on the
    card through B1, B6 and B3, and the same batch through their plain
    versions on the card gives the same paths and scores bit for bit."""
    rng = np.random.default_rng(23)
    params = presets.dinuc_cpg(device=cuda_device)
    N, T = 6, 3000
    chunks = torch.from_numpy(_decode_symbols(rng, 16, (N, T))).to(cuda_device)
    lengths = torch.tensor([3000, 2000, 2, 2999, 1500, 3000], dtype=torch.int32,
                           device=cuda_device)
    kernels = ("oh_products", "oh_backpointers_scores", "oh_backtrace")
    before = {k: _kernels.launches[k] for k in kernels}
    paths, scores = OH.decode_batch_flat(params, chunks, lengths, block_size=512,
                                         return_score=True)
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in kernels)
    for k in kernels:
        monkeypatch.setattr(OH, k, getattr(OH, f"{k}_plain"))
    paths_p, scores_p = OH.decode_batch_flat(params, chunks, lengths, block_size=512,
                                             return_score=True)
    assert torch.equal(paths, paths_p) and torch.equal(scores, scores_p)
    assert torch.isfinite(scores).all()


@pytest.mark.parametrize("seg", [1, 3, 64])
@pytest.mark.parametrize("M", [1, 2, 5])
@pytest.mark.parametrize("bk,nb", [(24, 33), (520, 65), (4104, 31)])
def test_backtrace_segments_equal_one_walk(cuda_device, monkeypatch, bk, nb, M, seg):
    """B3 and B28 with ``seg``-word segments (the kernel lengthens them
    where a lane would need more than its 32 segments: 17 words at 4,104
    steps for 1 and 3) equal the one walk's plain version bit for bit; one
    launch a call."""
    monkeypatch.setattr(OH, "BT_SEG_WORDS", seg)
    rng = np.random.default_rng(bk + nb + M + seg)
    members = _decode_members(4, M, cuda_device)
    steps = _decode_symbols(rng, 4, (nb, bk)).T.astype(np.int32).copy()
    steps[rng.random((bk, nb)) < 0.02] = 4
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01).to(cuda_device)
    _, _, tabs, idtabs, pair2, _, _, _ = OH.stacked_prepared(
        members, torch.from_numpy(steps).to(cuda_device), int(steps[0, 0]) % 4, resets)
    tabs, idtabs = torch.stack(tabs), torch.stack(idtabs)
    v = torch.from_numpy(rng.normal(size=(M, 2, nb)).astype(np.float32)).to(cuda_device)
    bits = torch.from_numpy(rng.integers(0, 2, size=(M, nb)).astype(np.int32)).to(cuda_device)
    bp = OH.oh_backpointers_stacked_plain(pair2, v, tabs)[0]
    want = OH.oh_backtrace_stacked_plain(bp, pair2, idtabs, bits)
    kernels = ("oh_backtrace", "oh_backtrace_stacked")
    before = {k: _kernels.launches[k] for k in kernels}
    path = OH.oh_backtrace_stacked(bp, pair2, idtabs, bits)
    one = OH.oh_backtrace(bp[0].contiguous(), pair2, idtabs[0], bits[0].contiguous())
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in kernels)
    assert torch.equal(path, want)
    assert torch.equal(one, want[0])


@pytest.mark.parametrize("S,M", [(4, 3), (16, 2)])
def test_decode_batch_flat_stacked_cuda_equals_cpu(cuda_device, S, M):
    """The stacked flat decode on the card (B26, B27's scores arm and B28
    once each, B1-B3 and B6 never) equals the CPU's bit for bit, and each
    member equals its own flat decode on the card."""
    rng = np.random.default_rng(31 + S + M)
    N, T = 7, 2500
    chunks = _decode_symbols(rng, S, (N, T))
    chunks[1, 500:560] = S
    lengths = np.array([2500, 1800, 2, 2499, 900, 2500, 1234], np.int32)
    single = ("oh_products", "oh_backpointers", "oh_backpointers_scores", "oh_backtrace")
    out = {}
    for dev in ("cpu", "cuda"):
        members = _decode_members(S, M, dev)
        before = {k: _kernels.launches[k] for k in STACKED_DECODE + single}
        out[dev] = OH.decode_batch_flat_stacked(
            members, torch.from_numpy(chunks).to(dev), torch.from_numpy(lengths).to(dev),
            block_size=512, return_score=True)
        ran = {k: _kernels.launches[k] - before[k] for k in before}
        want = {"oh_products_stacked": 1, "oh_backpointers_stacked_scores": 1,
                "oh_backtrace_stacked": 1} if dev == "cuda" else {}
        assert {k: n for k, n in ran.items() if n} == want
    (pc, sc), (pg, sg) = out["cpu"], out["cuda"]
    assert torch.equal(pc, pg.cpu()) and torch.equal(sc, sg.cpu())
    for m, p in enumerate(_decode_members(S, M, cuda_device)):
        own, own_s = OH.decode_batch_flat(p, torch.from_numpy(chunks).to(cuda_device),
                                          torch.from_numpy(lengths).to(cuda_device),
                                          block_size=512, return_score=True)
        assert torch.equal(own, pg[m]) and torch.equal(own_s, sg[m])


@pytest.mark.parametrize("use_device", [True, False])
def test_decode_small_batch_stacked_cuda_equals_cpu(cuda_device, use_device):
    """The mixed-model flush unit on the card gives the CPU's island calls,
    record for record, with device or host islands."""
    rng = np.random.default_rng(41)
    batch = []
    for i in range(9):
        s = rng.choice(4, size=int(rng.integers(2000, 20000)), p=[0.3, 0.2, 0.2, 0.3])
        s[500:2000] = rng.choice(4, size=1500, p=[0.1, 0.4, 0.4, 0.1])
        batch.append((f"r{i}", s.astype(np.uint8)))
    owners = [i % 3 for i in range(len(batch))]
    out = {}
    for dev in ("cpu", "cuda"):
        _, out[dev] = pipeline._decode_small_batch_stacked(
            _decode_members(4, 3, dev), batch, owners, min_len=200,
            island_states_list=[None] * 3, use_device_list=[use_device] * 3,
            cap_boxes=[[1024] for _ in range(3)], phases={})
    assert [c.format_lines() for c in out["cpu"]] == [c.format_lines() for c in out["cuda"]]
    assert sum(len(c) for c in out["cuda"]) > 0


# -- T2-T4: the pair-composition variants of the forward chain ------------------


def _compose_case(rng, T, NL, device):
    """The flagship's pair tables (bare and B9's) and a chaining random
    pair stream [T, NL] with ragged lengths (a length-1 lane, odd ones, a
    full lane) and entering vectors."""
    from cpgisland_tpu_torch.tools import bench_compose

    syms = rng.integers(0, 4, size=(NL, T + 1)).astype(np.int32)
    pair2 = np.ascontiguousarray((syms[:, :-1] * 4 + syms[:, 1:]).T)
    lens = rng.integers(1, T + 1, size=NL).astype(np.int32) | 1
    lens[0] = T
    lens[-1] = 1
    a0 = rng.random((2, NL)).astype(np.float32) + 0.1
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    tab, tab_ext = bench_compose.pair_tables(device)
    return tab, tab_ext, t(pair2), t(lens[None, :]), t(a0)


@pytest.mark.parametrize("T,NL", [(8, 1), (4098, 33), (65536, 1024)])
def test_compose_kernels_bit_equal(cuda_device, monkeypatch, T, NL):
    """T2, T3 and T4 equal their plain versions bit for bit; T2 equals B9
    in one sub-lane (the chain they share) and T4 equals T3; each launches
    once."""
    from cpgisland_tpu_torch.ops import fb_compose as FC
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    tab, tab_ext, pair2, lens2, a0 = _compose_case(np.random.default_rng(T + NL), T, NL,
                                                   cuda_device)
    mats, comp = FC.mat_streams(tab, pair2), FC.composed_streams(tab, pair2)
    idx, tables = FC.compsel_index(pair2, 4), FC.composed_tables(tab)
    kernels = ("oh_fwd_strm", "oh_fwd_comp", "oh_fwd_compsel")
    before = {k: _kernels.launches[k] for k in kernels}
    strm = FC.oh_fwd_strm(mats, lens2, a0)
    c = FC.oh_fwd_comp(comp, lens2, a0)
    sel = FC.oh_fwd_compsel(idx, lens2, a0, *tables)
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in kernels)
    assert torch.equal(strm, FC.oh_fwd_strm_plain(mats, lens2, a0))
    assert torch.equal(c, FC.oh_fwd_comp_plain(comp, lens2, a0))
    assert torch.equal(sel, FC.oh_fwd_compsel_plain(idx, lens2, a0, *tables))
    monkeypatch.setattr(FB, "SUBLANE_T", T)
    assert torch.equal(strm, FB.oh_fwd(pair2, lens2, a0, tab_ext))
    assert torch.equal(sel, c)


def test_compose_bench_on_the_card(cuda_device, capsys):
    """The bench at a small size: all four variants pass the gate, and the
    launch counters move by exactly the calls it reports."""
    import json

    from cpgisland_tpu_torch.tools import bench_compose

    _kernels.reset_launches()
    assert bench_compose.main(["--mib", "1", "--lane-T", "4096", "--chain", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["engine"] == "cuda" and line["card"]
    assert all(v["gate_err"] < 1e-4 for v in line["variants"].values())
    assert {k: _kernels.launches[k] for k in line["calls"]} == line["calls"]


# -- B7 / B21 and B18 in sub-lanes -------------------------------------------------


def _prod_pairs(rng, T, NL, device):
    """A pair stream with PAD pairs scattered, a PAD run and a PAD tail on
    the last lane (a posterior span's short last lane)."""
    pair = rng.integers(0, 16, size=(T, NL)).astype(np.int32)
    pad = rng.random((T, NL)) < 0.05
    pair[pad] = 16 + rng.integers(0, 4, size=int(pad.sum()))
    pair[T // 2 : T // 2 + 70, 0] = 17
    pair[T - T // 5 :, -1] = 16
    return torch.from_numpy(pair).to(device)


@pytest.mark.parametrize("sub", [None, 1 << 20, 7])
@pytest.mark.parametrize("T", [8192, 9000])
@pytest.mark.parametrize("NL", [33, 8192])
def test_prod_sublanes_bit_equal(cuda_device, monkeypatch, NL, T, sub):
    """B7 at the module's sub-lanes (G = 16 or 17 on lanes of 8 Ki steps or
    more), in one sub-lane (G = 1) and in 32 short ones (the last of them
    short or empty): bit-equal to its plain version."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    if sub is not None:
        monkeypatch.setattr(FB, "PROD_SUBLANE_T", sub)
        monkeypatch.setattr(FB, "PROD_SUBLANES_FROM", 1)
    rng = np.random.default_rng(NL + T + (sub or 0))
    params = presets.durbin_cpg8(device=cuda_device)
    pair = _prod_pairs(rng, T, NL, cuda_device)
    tab = FB.prob_tab_ext(params, OH._groups(params))
    assert (FB.prod_sublanes(T) == 1) == (sub == 1 << 20)
    before = _kernels.launches["oh_prod"]
    got = FB.oh_prod(pair, tab)
    torch.cuda.synchronize()
    assert _kernels.launches["oh_prod"] == before + 1
    assert torch.equal(got, FB.oh_prod_plain(pair, tab))


@pytest.mark.parametrize("sub", [None, 1 << 20, 300])
@pytest.mark.parametrize("M", [2, 3])
def test_prod_stacked_sublanes_bit_equal(cuda_device, monkeypatch, M, sub):
    """B21 in sub-lanes and in one: equal to its plain version, and each
    member to its own B7 launch, bit for bit."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    _, _, prep, _, tabs = _stacked_batch(70, 9000, 4, M, cuda_device)
    if sub is not None:
        monkeypatch.setattr(FB, "PROD_SUBLANE_T", sub)
    assert (FB.prod_sublanes(prep.pair2.shape[0]) == 1) == (sub == 1 << 20)
    got = FB.oh_prod_stacked(prep.pair2, tabs)
    assert torch.equal(got, FB.oh_prod_stacked_plain(prep.pair2, tabs))
    for m in range(M):
        assert torch.equal(got[m], FB.oh_prod(prep.pair2, tabs[m].contiguous()))


def _dense_bwd_operands(rng, K, NL, T, device, lens_from3=()):
    """A seeded K-state model over 4 symbols and the backward's inputs from
    B16 on ragged chunks (an empty lane, a one-step lane, a short last
    lane, PAD tails; lanes 3, 4, ... of the lengths ``lens_from3`` where
    given)."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    A = torch.from_numpy(rng.dirichlet(np.ones(K), size=K).astype(np.float32)).to(device)
    B = torch.from_numpy(rng.dirichlet(np.ones(4), size=K).astype(np.float32)).to(device)
    steps = rng.integers(0, 4, size=(T, NL)).astype(np.int32)
    lens = np.full((1, NL), T, np.int32)
    lens[0, -1] = max(1, T // 3)
    if NL > 3:
        lens[0, 1:3] = [0, 1]
        lens[0, 3:-1] = rng.integers(1, T + 1, size=NL - 4)
        lens[0, 3 : 3 + len(lens_from3)] = lens_from3
    steps[np.arange(T)[:, None] >= lens] = 0
    steps2, lens2 = (torch.from_numpy(x).to(device) for x in (steps, lens))
    a0 = torch.from_numpy((rng.random((K, NL)) + 0.1).astype(np.float32)).to(device)
    alphas = FP.fb_fwd(steps2, lens2, a0, A, B)
    _, steps_next, cs_next = FP.backward_inputs(steps2, alphas)
    beta0 = torch.from_numpy((rng.random((K, NL)) + 0.5).astype(np.float32)).to(device)
    return steps_next, lens2, cs_next, beta0, A, B, alphas


@pytest.mark.parametrize("NL,T,sub", [(33, 4099, 300), (1024, 65536, None), (1024, 65536, 4096),
                                      (130, 9000, 1 << 20), (40, 3000, 93)])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_fb_bwd_sublanes_bit_equal(cuda_device, monkeypatch, K, NL, T, sub):
    """B18 at K <= 4 in sub-lanes (G = 13, 16 or 32) and in one (G = 1):
    bit-equal to its plain version, ragged lanes included."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    if sub is not None:
        monkeypatch.setattr(FP, "BWD_SUBLANE_T", sub)
        monkeypatch.setattr(FP, "BWD_SUBLANES_FROM", 1)
    rng = np.random.default_rng(K * 100 + NL + T)
    *args, _ = _dense_bwd_operands(rng, K, NL, T, cuda_device)
    assert (FP.bwd_sublanes(T, K) == 1) == (sub == 1 << 20)
    before = _kernels.launches["fb_bwd"]
    got = FP.fb_bwd(*args, T - 3)
    torch.cuda.synchronize()
    assert _kernels.launches["fb_bwd"] == before + 1
    assert torch.equal(got, FP.fb_bwd_plain(*args, T - 3))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("K", [5, 8])
def test_fb_bwd_wide_and_conf_stay_one_chain(cuda_device, monkeypatch, K):
    """B18 and B19 at K >= 5 stay one chain, state-split, and B19 at K = 2
    takes B18's sub-lanes: with the sub-lane length lowered they still
    equal their plain versions bit for bit."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    monkeypatch.setattr(FP, "BWD_SUBLANE_T", 300)
    monkeypatch.setattr(FP, "BWD_SUBLANES_FROM", 1)
    rng = np.random.default_rng(K)
    for k in (K, 2):
        *args, alphas = _dense_bwd_operands(rng, k, 70, 4099, cuda_device)
        if k == K:
            assert FP.bwd_sublanes(4099, k) == 1
            assert torch.equal(FP.fb_bwd(*args, 4096), FP.fb_bwd_plain(*args, 4096))
        mask = (torch.arange(k, device=cuda_device) < k // 2).float()
        steps_next, lens2, cs_next, beta0, A, B = args
        got = FP.fb_bwd_conf(steps_next, lens2, cs_next, beta0, alphas, mask, A, B, 4096)
        assert torch.equal(got, FP.fb_bwd_conf_plain(steps_next, lens2, cs_next, beta0, alphas,
                                                     mask, A, B, 4096))


# B19 in B18's layouts: (K, NL, T, sub-lane length) with G = 13 (300-step
# sub-lanes of 4,099 steps), G = 8 (the default, 8,192-step lanes) and G = 1
# at K <= 4; the state split at K = 5 and 8 (4 lanes a warp, 16 a block).
B19_CASES = ([(K, NL, T, sub) for K in (2, 3, 4)
              for NL, T, sub in ((33, 4099, 300), (70, 8192, None), (33, 4099, 1 << 20))]
             + [(K, NL, T, None) for K in (5, 8) for NL, T in ((33, 4099), (3, 9), (70, 8192))])


@pytest.mark.parametrize("K,NL,T,sub", B19_CASES)
def test_fb_bwd_conf_in_b18_layouts(cuda_device, monkeypatch, K, NL, T, sub):
    """B19 runs B18's layout at its K and lane length: bit for bit its
    plain version (the confidence over B18's betas), lanes of length 0, 1,
    the chunk length and the lane's included; one launch a call; nothing
    stored past the last lane (a sentinel after the confidence stays)."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    if sub is not None:
        monkeypatch.setattr(FP, "BWD_SUBLANE_T", sub)
        monkeypatch.setattr(FP, "BWD_SUBLANES_FROM", 1)
    rng = np.random.default_rng(K * 31 + NL + T)
    chunk = T - 3
    steps_next, lens2, cs_next, beta0, A, B, alphas = _dense_bwd_operands(
        rng, K, NL, T, cuda_device, lens_from3=(chunk, T))
    G = FP.bwd_sublanes(T, K)
    assert (G > 1) == (K <= 4 and sub != 1 << 20)
    mask = (torch.arange(K, device=cuda_device) < (K + 1) // 2).float()
    args = (steps_next, lens2, cs_next, beta0, alphas, mask, A, B, chunk)
    want = FP.fb_bwd_conf_plain(*args)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(want, FP.conf_from_streams(
        alphas, FP.fb_bwd_plain(steps_next, lens2, cs_next, beta0, A, B, chunk), lens2, mask))
    before = _kernels.launches["fb_bwd_conf"]
    assert torch.equal(FP.fb_bwd_conf(*args), want)
    buf = torch.full((T * NL + 64,), -3.0, device=cuda_device)
    qbuf = torch.empty((G, K * K + 1, NL) if G > 1 else (1,), device=cuda_device)
    _kernels.launch("fb_bwd_conf", steps_next, lens2, cs_next, beta0, alphas, mask, A, B,
                    buf[: T * NL].view(T, NL), qbuf, Tp=T, NL=NL, K=K, S=4, T=chunk, G=G)
    torch.cuda.synchronize()
    assert _kernels.launches["fb_bwd_conf"] == before + 2
    assert torch.equal(buf[: T * NL].view(T, NL), want)
    assert bool((buf[T * NL :] == -3.0).all())


# -- B16 in sub-lanes, B5 / B25's segments --------------------------------------------


def _dense_fwd_operands(rng, K, NL, T, device):
    """A seeded K-state model over 4 symbols and ragged lanes for B16 (an
    empty lane, a one-step lane, a short last lane, PAD tails)."""
    A = torch.from_numpy(rng.dirichlet(np.ones(K), size=K).astype(np.float32)).to(device)
    B = torch.from_numpy(rng.dirichlet(np.ones(4), size=K).astype(np.float32)).to(device)
    steps = rng.integers(0, 4, size=(T, NL)).astype(np.int32)
    lens = np.full((1, NL), T, np.int32)
    lens[0, -1] = max(1, T // 3)
    if NL > 3:
        lens[0, 1:3] = [0, 1]
        lens[0, 3:-1] = rng.integers(1, T + 1, size=NL - 4)
    steps[np.arange(T)[:, None] >= lens] = 4
    a0 = torch.from_numpy((rng.random((K, NL)) + 0.1).astype(np.float32)).to(device)
    return tuple(torch.from_numpy(x).to(device) for x in (steps, lens)) + (a0, A, B)


@pytest.mark.parametrize("NL,T,sub", [(33, 4099, 300), (1024, 65536, None), (1024, 65536, 4096),
                                      (130, 9000, 1 << 20), (40, 3000, 93), (8, 8192, None)])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_fb_fwd_sublanes_bit_equal(cuda_device, monkeypatch, K, NL, T, sub):
    """B16 at K <= 4 in sub-lanes (G = 8 to 32) and in one (G = 1): bit-equal
    to its plain version, ragged lanes and lanes ending inside and past a
    sub-lane included."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    if sub is not None:
        monkeypatch.setattr(FP, "FWD_SUBLANE_T", sub)
        monkeypatch.setattr(FP, "FWD_SUBLANES_FROM", 1)
    rng = np.random.default_rng(K * 100 + NL + T)
    args = _dense_fwd_operands(rng, K, NL, T, cuda_device)
    assert (FP.fwd_sublanes(T, K) == 1) == (sub == 1 << 20)
    before = _kernels.launches["fb_fwd"]
    got = FP.fb_fwd(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["fb_fwd"] == before + 1
    assert torch.equal(got, FP.fb_fwd_plain(*args))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("K", [5, 8])
def test_fb_fwd_wide_stays_one_chain(cuda_device, monkeypatch, K):
    """B16 at K >= 5 stays one chain, state-split: with the sub-lane length
    lowered it still equals the sequential plain chain bit for bit."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    monkeypatch.setattr(FP, "FWD_SUBLANE_T", 300)
    monkeypatch.setattr(FP, "FWD_SUBLANES_FROM", 1)
    args = _dense_fwd_operands(np.random.default_rng(K), K, 70, 4099, cuda_device)
    assert FP.fwd_sublanes(4099, K) == 1
    assert torch.equal(FP.fb_fwd(*args), FP._fwd_chain_plain(*args))


def _split_operands(rng, K, S, NL, T, device):
    """A seeded K-state model over S symbols and ragged lanes of T steps (an
    empty lane, a one-step lane, a short last lane, PAD tails) for the
    state-split chains."""
    A = torch.from_numpy(rng.dirichlet(np.ones(K), size=K).astype(np.float32)).to(device)
    B = torch.from_numpy(rng.dirichlet(np.ones(S), size=K).astype(np.float32)).to(device)
    steps = rng.integers(0, S, size=(T, NL)).astype(np.int32)
    lens = np.full((1, NL), T, np.int32)
    lens[0, -1] = max(1, T // 3)
    if NL > 3:
        lens[0, 1:3] = [0, 1]
        lens[0, 3:-1] = rng.integers(1, T + 1, size=NL - 4)
    elif NL == 3:
        lens[0, :2] = [0, 1]
    steps[np.arange(T)[:, None] >= lens] = S
    a0 = torch.from_numpy((rng.random((K, NL)) + 0.1).astype(np.float32)).to(device)
    beta0 = torch.from_numpy((rng.random((K, NL)) + 0.5).astype(np.float32)).to(device)
    return tuple(torch.from_numpy(x).to(device) for x in (steps, lens)) + (a0, beta0, A, B)


@pytest.mark.parametrize("S", [4, 16])
@pytest.mark.parametrize("T", [9, 4099])
@pytest.mark.parametrize("NL", [1, 3, 33, 1024])
@pytest.mark.parametrize("K", [5, 6, 7, 8])
def test_fb_state_split_chains_bit_equal(cuda_device, K, NL, T, S):
    """B16 and B18 at K >= 5, one chain split one thread a state (4 lanes a
    warp, so NL = 1, 3 and 33 leave a warp part-empty): bit-equal to the
    sequential plain chains, empty, one-step, ragged and PAD-tailed lanes
    included, B18 with its chunk length at the lane length and below it;
    one launch a call."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    rng = np.random.default_rng(K * 1000 + NL * 10 + T + S)
    steps2, lens2, a0, beta0, A, B = _split_operands(rng, K, S, NL, T, cuda_device)
    assert FP.fwd_sublanes(T, K) == FP.bwd_sublanes(T, K) == 1
    before = {k: _kernels.launches[k] for k in ("fb_fwd", "fb_bwd")}
    alphas = FP.fb_fwd(steps2, lens2, a0, A, B)
    torch.cuda.synchronize()
    assert _kernels.launches["fb_fwd"] == before["fb_fwd"] + 1
    assert torch.equal(alphas, FP._fwd_chain_plain(steps2, lens2, a0, A, B))
    assert bool(torch.isfinite(alphas).all())
    _, steps_next, cs_next = FP.backward_inputs(steps2, alphas)
    args = (steps_next, lens2, cs_next, beta0, A, B)
    for chunk in (T, T - 3):
        got = FP.fb_bwd(*args, chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, FP._bwd_chain_plain(*args, chunk))
        assert bool(torch.isfinite(got).all())
    assert _kernels.launches["fb_bwd"] == before["fb_bwd"] + 2


@pytest.mark.parametrize("K", [5, 8])
def test_fb_state_split_chains_full_lanes(cuda_device, K):
    """The state-split chains at the training batch's 1,024 ragged lanes of
    65,536 steps: bit-equal to the sequential plain chains."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    rng = np.random.default_rng(K)
    steps2, lens2, a0, beta0, A, B = _split_operands(rng, K, 4, 1024, 65536, cuda_device)
    alphas = FP.fb_fwd(steps2, lens2, a0, A, B)
    assert torch.equal(alphas, FP._fwd_chain_plain(steps2, lens2, a0, A, B))
    _, steps_next, cs_next = FP.backward_inputs(steps2, alphas)
    args = (steps_next, lens2, cs_next, beta0, A, B, 65536)
    assert torch.equal(FP.fb_bwd(*args), FP._bwd_chain_plain(*args))


@pytest.mark.parametrize("seg", [256, 2048])
@pytest.mark.parametrize("NL,T", [(33, 4099), (1024, 65536), (40, 9)])
def test_seq_stats_segments_within_tolerance(cuda_device, monkeypatch, NL, T, seg):
    """B5 at two segment lengths: within rtol 1e-5 / atol 1e-3 of its plain
    version, and two launches give the same bits (no atomics)."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    monkeypatch.setattr(FB, "STATS_SEGMENT_T", seg)
    rng = np.random.default_rng(NL * 13 + T + seg)
    params, prep, gt, a0, b0, tab = _fb_inputs(rng, NL, T, cuda_device)
    al2, b2 = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, T)
    K, S = params.n_states, params.n_symbols
    dev = lambda x: torch.from_numpy(x.astype(np.float32)).to(cuda_device)  # noqa: E731
    args = (al2, b2, prep.pair2, prep.lens2, tab, FB.reduced_emissions(params, gt),
            gt.to(torch.int32).contiguous(), dev(rng.random((K, NL))), dev(rng.random((2, NL))),
            dev(rng.integers(0, 2, size=(1, NL))))
    got = FB.oh_seq_stats(*args)
    again = FB.oh_seq_stats(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, FB.oh_seq_stats_plain(*args)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seg", [256, 2048])
@_STACK_GRID
def test_seq_stats_stacked_segments(cuda_device, monkeypatch, S, seg):
    """B25 at two segment lengths: within B5's tolerance of its plain
    version, each member equal to its own B5 bit for bit, and two launches
    equal."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    monkeypatch.setattr(FB, "STATS_SEGMENT_T", seg)
    M, NL, T = 2, 33, 4099
    rng, members, prep, gts, tabs = _stacked_batch(NL, T, S, M, cuda_device)
    K = 2 * S
    v = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.random(shape).astype(np.float32) + 0.01).to(cuda_device)
    al, be = FB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, v(M, 2, NL),
                                  v(M, 2, NL), tabs, T)
    B_reds = torch.stack([FB.reduced_emissions(p, gt) for p, gt in zip(members, gts)])
    gts32 = gts.to(torch.int32).contiguous()
    pair0m = torch.from_numpy(rng.integers(0, 2, size=(1, NL)).astype(np.float32)).to(cuda_device)
    args = (al, be, prep.pair2, prep.lens2, tabs, B_reds, gts32, v(M, K, NL), v(M, 2, NL),
            pair0m)
    got = FB.oh_seq_stats_stacked(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, FB.oh_seq_stats_stacked(*args)))
    for g, w in zip(got, FB.oh_seq_stats_stacked_plain(*args)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-3)
    for m in range(M):
        single = FB.oh_seq_stats(al[m], be[m], prep.pair2, prep.lens2, tabs[m].contiguous(),
                                 B_reds[m], gts32[m], args[7][m], args[8][m], pair0m)
        assert all(torch.equal(a, b[m]) for a, b in zip(single, got))


# -- the scoring kernels in sub-lanes --------------------------------------------


@pytest.mark.parametrize("T", [8192, 65536])
@_STACK_M
@pytest.mark.parametrize("NL", [3, 33, 1024])
def test_reduced_scoring_sublanes(cuda_device, NL, M, T):
    """The reduced scoring chain on lanes of 8 Ki and 64 Ki steps (G = 32
    sub-lanes of 256 and 2 Ki steps; an empty lane, ragged PAD tails; blocks
    of 1 to 8 lanes), flagship and random members: per-lane sums within
    1e-12 of the plain version, one launch, each member equal to its own
    M = 1 launch bit for bit."""
    from cpgisland_tpu_torch.ops import loglik as LL

    rng, _, prep, _, tabs = _stacked_batch(NL, T, 4, M, cuda_device)
    assert LL.loglik_sublanes(prep.pair2.shape[0]) > 1
    e = rng.random((M, 2, NL)).astype(np.float32) + 0.01
    enter = torch.from_numpy(e / e.sum(axis=1, keepdims=True)).to(cuda_device)
    before = _kernels.launches["oh_loglik"]
    got = LL.oh_loglik(prep.pair2, enter, tabs)
    assert _kernels.launches["oh_loglik"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               LL.oh_loglik_plain(prep.pair2, enter, tabs).cpu().numpy(),
                               rtol=1e-12)
    for m in range(M):
        one = LL.oh_loglik(prep.pair2, enter[m : m + 1], tabs[m : m + 1].contiguous())
        assert torch.equal(one[0], got[m])


def test_reduced_scoring_sublanes_impossible_pair(cuda_device):
    """dinuc_cpg with pairs of all-zero 2x2 tables planted inside a
    sub-lane, at a sub-lane's first step and at a lane's first step: the
    lanes that hold one score -inf, never nan, on the card as in the plain
    version; the other member scores them finite."""
    from cpgisland_tpu_torch.ops import loglik as LL

    rng, _, prep, _, tabs = _stacked_batch(3, 8192, 16, 2, cuda_device)
    zero = int(torch.nonzero(tabs[0, :-1].abs().sum(1) == 0)[0, 0])
    pair2 = prep.pair2.clone()
    pair2[700, 0] = pair2[1024, 0] = pair2[0, 2] = zero
    enter = torch.full((2, 2, 3), 0.5, device=cuda_device)
    got = LL.oh_loglik(pair2, enter, tabs)
    want = LL.oh_loglik_plain(pair2, enter, tabs)
    assert not torch.isnan(got).any()
    assert got[0, 0] == got[0, 2] == -float("inf")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-12)


@pytest.mark.parametrize("T", [8192, 65536])
@pytest.mark.parametrize("model", ["two_state", "null4", "impossible"])
@pytest.mark.parametrize("NL", [3, 33, 1024])
def test_dense_scoring_sublanes(cuda_device, NL, model, T):
    """The dense scoring chain (K = 2, 1) on lanes of 8 Ki and 64 Ki steps
    (G = 32) with PADs, an all-PAD lane and a PAD tail: within 1e-12
    per lane of its plain version, one launch.  ``impossible``: a K = 2
    model whose symbol 2 has probability 0, planted at a sub-lane's first
    step and inside one: those lanes -inf, never nan."""
    from cpgisland_tpu_torch.ops import fb_pallas as FP
    from cpgisland_tpu_torch.ops import loglik as LL

    if model == "impossible":
        A = torch.tensor([[0.9, 0.1], [0.2, 0.8]], device=cuda_device)
        B = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.2, 0.8, 0.0, 0.0]], device=cuda_device)
    else:
        params = {"two_state": lambda: presets.two_state_cpg(device=cuda_device),
                  "null4": lambda: presets.null_background(4, device=cuda_device)}[model]()
        A, B, _ = FP.tables(params)
    K, S = B.shape
    rng = np.random.default_rng(NL + K + T)
    sel = rng.integers(0, 2 if model == "impossible" else S, size=(T, NL)).astype(np.int32)
    sel[rng.random(sel.shape) < 0.05] = S
    sel[:, 1] = S
    sel[T // 3 :, -1] = S
    if model == "impossible":
        sel[512, 0] = sel[5000, 2] = 2
    e = rng.random((K, NL)).astype(np.float32) + 0.01
    enter = torch.from_numpy(e / e.sum(axis=0)).to(cuda_device)
    sel_d = torch.from_numpy(sel).to(cuda_device)
    assert LL.loglik_sublanes(T, K) > 1
    before = _kernels.launches["fb_loglik"]
    got = LL.fb_loglik(sel_d, enter, A, B)
    assert _kernels.launches["fb_loglik"] == before + 1
    assert not torch.isnan(got).any()
    if model == "impossible":
        assert got[0] == got[2] == -float("inf")
    np.testing.assert_allclose(got.cpu().numpy(),
                               LL.fb_loglik_plain(sel_d, enter, A, B).cpu().numpy(), rtol=1e-12)


# -- B9 / B22 and B10 / B23 in sub-lanes ------------------------------------------


def _split_sublane_args(NL, T, M, device):
    """A ragged chunked batch, M members' pair tables (the flagship first)
    and entering vectors, B9's alphas and B10's cs_next from them."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    rng, _, prep, _, tabs = _stacked_batch(NL, T, 4, M, device)
    v = lambda: torch.from_numpy(  # noqa: E731
        rng.random((M, 2, NL)).astype(np.float32) + 0.01).to(device)
    a0, b0 = v(), v()
    al = FB.oh_fwd_stacked(prep.pair2, prep.lens2, a0, tabs)
    return prep, tabs, a0, b0, FB.cs_next_of(al)


@pytest.mark.parametrize("sub", [None, 300, "lane"])
@pytest.mark.parametrize("NL,T", [(33, 9000), (1024, 65536), (40, 4099)])
def test_split_chains_in_sublanes_bit_equal(cuda_device, monkeypatch, NL, T, sub):
    """B9, B10 and B11 at their default sub-lanes (``sub`` None), in
    sub-lanes of 300 steps (B10 and B11 at every lane length) and in one
    sub-lane ("lane"): each equals its plain version bit for bit, B9's
    alphas B4's, B11's confidence the epilogue over B10's betas, and each
    launch counts once."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    prep, tabs, a0, b0, cs = _split_sublane_args(NL, T, 1, cuda_device)
    Tp = prep.pair2.shape[0]
    st = {None: None, 300: 300, "lane": Tp}[sub]
    if st is not None:
        monkeypatch.setattr(FB, "SUBLANE_T", st)
        monkeypatch.setattr(FP, "BWD_SUBLANE_T", st)
        monkeypatch.setattr(FP, "BWD_SUBLANES_FROM", 1)
    tab = tabs[0].contiguous()
    fargs = (prep.pair2, prep.lens2, a0[0], tab)
    bargs = (prep.pairn2, prep.lens2, cs[0], b0[0], tab, T)
    mtab = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.0, 0.0]],
                        device=cuda_device)
    before = {k: _kernels.launches[k] for k in ("oh_fwd", "oh_bwd", "oh_bwd_conf")}
    al, be = FB.oh_fwd(*fargs), FB.oh_bwd(*bargs)
    cargs = (prep.pairn2, prep.pair2, prep.lens2, cs[0], b0[0], al, mtab, tab, T)
    conf = FB.oh_bwd_conf(*cargs)
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in before)
    assert torch.equal(al, FB.oh_fwd_plain(*fargs))
    assert torch.equal(be, FB.oh_bwd_plain(*bargs))
    assert torch.equal(conf, FB.oh_bwd_conf_plain(*cargs))
    esym = FB.decode_esym(prep.pair2, 4)
    assert torch.equal(conf, FB._conf_from_mtab(al, be, esym, prep.lens2, mtab))
    al4, _ = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0[0], b0[0], tab, T)
    assert torch.equal(al, al4)
    assert (FB.sublanes(Tp) > 1) == (sub != "lane" and (sub == 300 or T >= 8192))


@pytest.mark.parametrize("sub", [None, 300, "lane"])
@_STACK_M
def test_split_stacked_in_sublanes_bit_equal(cuda_device, monkeypatch, M, sub):
    """B22 and B23 at the default sub-lanes, in sub-lanes of 300 steps and
    in one: equal to their plain versions and per member to B9 / B10 bit
    for bit, B22's alphas B24's."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    NL, T = 70, 16384
    st = {None: None, 300: 300, "lane": T}[sub]
    if st is not None:
        monkeypatch.setattr(FB, "SUBLANE_T", st)
        monkeypatch.setattr(FP, "BWD_SUBLANE_T", st)
        monkeypatch.setattr(FP, "BWD_SUBLANES_FROM", 1)
    prep, tabs, a0, b0, cs = _split_sublane_args(NL, T, M, cuda_device)
    al = FB.oh_fwd_stacked(prep.pair2, prep.lens2, a0, tabs)
    be = FB.oh_bwd_stacked(prep.pairn2, prep.lens2, cs, b0, tabs, T)
    assert torch.equal(al, FB.oh_fwd_stacked_plain(prep.pair2, prep.lens2, a0, tabs))
    assert torch.equal(be, FB.oh_bwd_stacked_plain(prep.pairn2, prep.lens2, cs, b0, tabs, T))
    for m in range(M):
        tab = tabs[m].contiguous()
        assert torch.equal(al[m], FB.oh_fwd(prep.pair2, prep.lens2, a0[m], tab))
        assert torch.equal(be[m], FB.oh_bwd(prep.pairn2, prep.lens2, cs[m], b0[m], tab, T))
    al24, _ = FB.oh_fwdbwd_stacked(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tabs, T)
    assert torch.equal(al, al24)


def _drift_streams(rng, Tp, NL, sub, growth):
    """The flagship's pair table, next-step pairs (PADs scattered), a
    cs_next whose backward betas drift by 2^growth[g] over sub-lane g of
    ``sub`` steps (t walking down), beta0, and each step's 2x2 matrix in
    float64 [Tp, NL, 2, 2]: cs_next[t] is the float64 self-normalized
    chain's normalizer over the step's factor, so the betas move between
    2^-100 and 2^100 while a sub-lane's unscaled transfer matrix can leave
    float32's range."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB

    params = presets.durbin_cpg8()
    tab = FB.prob_tab_ext(params, OH._groups(params))
    nreal = tab.shape[0] - 1
    pairn = rng.integers(0, nreal, size=(Tp, NL)).astype(np.int32)
    pairn[rng.random((Tp, NL)) < 0.05] = nreal + 1
    pairn[-1] = nreal  # the last row: the identity's PAD
    b0 = (rng.random((2, NL)) + 0.5).astype(np.float32)
    G64 = tab.double().numpy()[np.minimum(pairn, nreal)].reshape(Tp, NL, 2, 2)
    d = b0.astype(np.float64) / b0.sum(0)
    cs = np.ones((Tp, NL))
    for t in range(Tp - 2, -1, -1):  # t <= T - 2 with T = Tp
        raw = np.einsum("nac,cn->an", G64[t], d)
        norm = raw.sum(0)
        d = raw / norm
        cs[t] = norm / 2.0 ** (growth[t // sub] / sub)
    return tab, pairn, cs.astype(np.float32), b0, G64


def test_split_bwd_sublanes_keep_the_range(cuda_device, monkeypatch):
    """B10 in three sub-lanes of 1,024 steps over a cs_next that drifts the
    betas by 2^-100, 2^200 and 2^-100 (the middle sub-lane's unscaled
    product overflows float32): bit-equal to its plain version, finite,
    within rtol 1e-5 of the sequential chain."""
    from cpgisland_tpu_torch.ops import fb_onehot as FB
    from cpgisland_tpu_torch.ops import fb_pallas as FP

    Tp, NL = 3072, 6
    tab, pairn, cs, b0, _ = _drift_streams(np.random.default_rng(7), Tp, NL, 1024,
                                           (-100, 200, -100))
    lens = np.full((1, NL), Tp, np.int32)
    lens[0, 4] = 3000
    monkeypatch.setattr(FP, "BWD_SUBLANE_T", 1024)
    monkeypatch.setattr(FP, "BWD_SUBLANES_FROM", 1)
    t = lambda x: torch.from_numpy(x).to(cuda_device)  # noqa: E731
    args = (t(pairn), t(lens), t(cs), t(b0), tab.to(cuda_device), Tp)
    got = FB.oh_bwd(*args)
    assert torch.equal(got, FB.oh_bwd_plain(*args))
    assert torch.isfinite(got).all() and float(got.max()) > 2.0**90
    seq = FB._bwd_plain(args[0], args[1], args[3], args[4], Tp, cs_next=args[2])
    torch.testing.assert_close(got, seq, rtol=1e-5, atol=0)
