"""The pair-composition variants of the port (T2-T4, ``ops/fb_compose.py``)
and its bench (``tools/bench_compose.py``) vs the JAX package.

On the CPU each wrapper takes its plain PyTorch version.  The reference is
the JAX package's single-step XLA twin ``fb_onehot._xla_fwd_onehot``, the
one ``tools/bench_compose.py`` gates its variants against.  Both sides get
the JAX package's own ``prob_pair_table`` of ``durbin_cpg8`` as numpy, so
XLA:CPU's ``exp`` does not enter, and the same seeded numpy stream: 4,096
steps x 48 lanes of chaining random pairs, with ragged lengths (odd ones,
a length-1 lane, a full lane).  The single-step variant is held within
rtol 1e-5 (XLA:CPU contracts ``a*b + c*d`` into fused multiply-adds; the
port rounds every product, as the CUDA kernels do), the composed ones
within the JAX script's gate; between the port's own plain versions the
relations are exact.  The script's stream and table helpers are closures
inside its ``main``, so the tests below transcribe its lines (cited) onto
the JAX table rather than import them.

T2-T4 run in B9's sub-lanes (``fb_onehot.sublanes``); 4,096-step lanes
are one sub-lane.  The sub-lane tests lower ``fb_onehot.SUBLANE_T`` so that
lanes of 8,194 and 4,096 steps run as 8 and 4 sub-lanes, with lengths on
every side of the sub-lane boundaries.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import fb_onehot as JFB
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu_torch.ops import fb_compose as FC
from cpgisland_tpu_torch.ops import fb_onehot as TFB
from cpgisland_tpu_torch.tools import bench_compose

S = 4
TP, NL = 4096, 48
IDENT = np.asarray(JFB.PROB_IDENT, np.float32)


def _jax_table() -> np.ndarray:
    params = JP.durbin_cpg8()
    return np.array(JFB.prob_pair_table(params, JOH._groups(params)))


def _stream(seed=0):
    """(pair2 [TP, NL] int32 chaining per lane, lens2 [1, NL], a0 [2, NL])."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, S, size=(NL, TP + 1)).astype(np.int32)
    pair2 = np.ascontiguousarray((syms[:, :-1] * S + syms[:, 1:]).T)
    lens = rng.integers(1, TP + 1, size=NL).astype(np.int32)
    lens[0], lens[1], lens[2], lens[3], lens[4] = TP, 1, TP - 1, 2, 3
    lens[5:12] |= 1  # odd lengths end on a double step's even half
    a0 = rng.random((2, NL)).astype(np.float32) + 0.1
    return pair2, lens[None, :], a0


@pytest.fixture(scope="module")
def case():
    tab = _jax_table()
    pair2, lens2, a0 = _stream()
    tab_ext = np.concatenate([tab, IDENT[None, :]])
    want = np.asarray(jax.jit(JFB._xla_fwd_onehot)(
        jnp.asarray(tab_ext), jnp.asarray(pair2), jnp.asarray(lens2), jnp.asarray(a0).T))
    t = {k: torch.from_numpy(v) for k, v in
         dict(tab=tab, tab_ext=tab_ext, pair2=pair2, lens2=lens2, a0=a0).items()}
    b9 = TFB.oh_fwd_plain(t["pair2"], t["lens2"], t["a0"], t["tab_ext"])
    comp = FC.oh_fwd_comp_plain(FC.composed_streams(t["tab"], t["pair2"]), t["lens2"], t["a0"])
    return tab, want, t, b9, comp


def _gate(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)))


# -- T2: the streamed single-step chain


def test_strm_plain_equals_b9_plain_and_matches_xla(case):
    _, want, t, b9, _ = case
    al = FC.oh_fwd_strm_plain(FC.mat_streams(t["tab"], t["pair2"]), t["lens2"], t["a0"])
    assert torch.equal(al, b9)
    np.testing.assert_allclose(al.numpy(), want, rtol=1e-5)


def test_mat_streams_are_the_scripts(case):
    """bench_compose.py:132-133, ``tab[:, k][pair2]`` for k = 0..3."""
    tab, _, t, _, _ = case
    got = FC.mat_streams(t["tab"], t["pair2"]).numpy()
    pair2 = t["pair2"].numpy()
    for k in range(4):
        assert np.array_equal(got[k], tab[:, k][pair2])


# -- T3, T4: the double-step chain


def test_composed_plain_within_the_scripts_gate(case):
    """The JAX script's gate is max rel err < 1e-4 (1e-3 floor); measured
    here 1.1e-6 for both (B9's plain version: 7e-7 relative), so the bound
    is tightened to 1e-5."""
    _, want, _, _, comp = case
    err = _gate(comp.numpy(), want)
    assert err < 1e-5, err


def test_compsel_plain_equals_composed_plain(case):
    tab, _, t, _, comp = case
    idx = FC.compsel_index(t["pair2"], S)
    sel = FC.oh_fwd_compsel_plain(idx, t["lens2"], t["a0"], *FC.composed_tables(t["tab"]))
    assert torch.equal(sel, comp)


def test_composed_ragged_lanes_carry_as_the_single_step_chain(case):
    """A lane of odd length ends on a double step's even half; every row
    past a lane's length repeats its last alpha, as in B9."""
    _, _, t, _, comp = case
    lens = t["lens2"][0]
    for n in range(12):
        last = int(lens[n]) - 1
        assert torch.equal(comp[last:, :, n], comp[last, :, n].expand(TP - last, 2))
    assert torch.equal(comp[0], t["a0"])


def test_composed_streams_are_the_scripts(case):
    """bench_compose.py:187-203 in numpy: T2 entrywise, R the row sums of
    the even half, the even half with an identity on double step 0."""
    tab, _, t, _, _ = case
    pair2 = t["pair2"].numpy()
    ge = [tab[:, k][pair2[0::2]] for k in range(4)]
    go = [tab[:, k][pair2[1::2]] for k in range(4)]
    for k, idv in enumerate(IDENT):
        ge[k][0] = idv
    t2 = (ge[0] * go[0] + ge[1] * go[2], ge[0] * go[1] + ge[1] * go[3],
          ge[2] * go[0] + ge[3] * go[2], ge[2] * go[1] + ge[3] * go[3])
    rs = (ge[0] + ge[1], ge[2] + ge[3])
    want = np.stack([*t2, *rs, *ge])
    assert np.array_equal(FC.composed_streams(t["tab"], t["pair2"]).numpy(), want)


def test_compsel_index_is_the_scripts(case):
    """bench_compose.py:346-351."""
    _, _, t, _, _ = case
    pair2 = t["pair2"].numpy()
    trip = pair2[0::2] * (S + 1) + pair2[1::2] % S
    paire = pair2[0::2].copy()
    trip[0] = S * S * (S + 1) + pair2[1]
    paire[0] = S * S
    got = FC.compsel_index(t["pair2"], S)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.stack([trip, paire]))


def test_composed_tables_match_the_scripts():
    """bench_compose.py:270-285 applied to the JAX table: rtab and ttab
    equal, t2tab within one f32 ulp (the script composes with a numpy
    matmul, the port with T3's elementwise formula)."""
    tab = _jax_table()
    tab_np = tab.reshape(S * S, 2, 2)
    rows = []
    for p in range(S * S):
        e = p % S
        for q in range(S + 1):
            m = tab_np[p] @ tab_np[e * S + q] if q < S else tab_np[p]
            rows.append(m.reshape(4))
    t2tab = np.concatenate([np.stack(rows), tab_np.reshape(S * S, 4)])
    rtab = np.concatenate([tab_np.sum(axis=2), np.ones((1, 2), np.float32)])
    ttab = np.concatenate([tab, IDENT[None, :]])
    g_t2, g_r, g_t = (x.numpy() for x in FC.composed_tables(torch.from_numpy(tab)))
    assert g_t2.shape == (96, 4) and g_r.shape == (17, 2) and g_t.shape == (17, 4)
    assert np.array_equal(g_r, rtab) and np.array_equal(g_t, ttab)
    ulp = np.spacing(np.maximum(np.abs(g_t2), np.abs(t2tab)))
    assert np.all(np.abs(g_t2 - t2tab) <= ulp)


# -- the wrappers


def test_wrappers_take_the_plain_versions_on_the_cpu(case):
    _, _, t, b9, comp = case
    tab, pair2, lens2, a0 = t["tab"], t["pair2"], t["lens2"], t["a0"]
    assert torch.equal(FC.oh_fwd_strm(FC.mat_streams(tab, pair2), lens2, a0), b9)
    assert torch.equal(FC.oh_fwd_comp(FC.composed_streams(tab, pair2), lens2, a0), comp)
    got = FC.oh_fwd_compsel(FC.compsel_index(pair2, S), lens2, a0, *FC.composed_tables(tab))
    assert torch.equal(got, comp)


@pytest.mark.parametrize("build", [FC.composed_streams,
                                   lambda tab, p: FC.compsel_index(p, S)])
def test_composed_variants_refuse_an_odd_tp(case, build):
    _, _, t, _, _ = case
    with pytest.raises(ValueError, match="even"):
        build(t["tab"], t["pair2"][:-1])


def test_wrappers_refuse_wrong_dtypes_and_shapes(case):
    _, _, t, _, _ = case
    tab, pair2, lens2, a0 = t["tab"], t["pair2"][:64], t["lens2"], t["a0"]
    mats = FC.mat_streams(tab, pair2)
    comp = FC.composed_streams(tab, pair2)
    idx = FC.compsel_index(pair2, S)
    tables = FC.composed_tables(tab)
    bad = [
        lambda: FC.oh_fwd_strm(mats.double(), lens2, a0),
        lambda: FC.oh_fwd_strm(mats[:3], lens2, a0),
        lambda: FC.oh_fwd_strm(mats, lens2[:, :-1], a0),
        lambda: FC.oh_fwd_strm(mats[:, :, ::2], lens2[:, ::2].contiguous(),
                               a0[:, ::2].contiguous()),
        lambda: FC.oh_fwd_comp(comp, lens2.long(), a0),
        lambda: FC.oh_fwd_comp(comp[:4], lens2, a0),
        lambda: FC.oh_fwd_comp(comp, lens2, a0[:, :-1]),
        lambda: FC.oh_fwd_compsel(idx.long(), lens2, a0, *tables),
        lambda: FC.oh_fwd_compsel(idx, lens2, a0, tables[0][:-1], *tables[1:]),
        lambda: FC.oh_fwd_compsel(idx, lens2, a0, tables[0], tables[1][:, :1], tables[2]),
        lambda: FC.mat_streams(tab[:15], pair2),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# -- T2-T4 in B9's sub-lanes
#
# fb_onehot.SUBLANE_T is lowered so that the lanes run as G sub-lanes: G = 8
# on 8,194 steps (L = 1,025 and, for T3, Lh = 513 double steps: neither
# divides its lane), G = 4 on 4,096 (both divide).

SUB_CASES = [(8194, 1024), (4096, 1024)]


def _sub_stream(Tp: int, st: int, seed: int):
    """A chaining pair stream [Tp, NL] whose ragged lengths hit lengths 1, 2
    and 3, odd lengths, a full lane and every side of the first sub-lane
    boundaries of T2 (L steps) and of T3 (2 Lh steps)."""
    rng = np.random.default_rng(seed)
    G = max(1, min(Tp // st, 32))
    L, Lh = -(-Tp // G), -(-(Tp // 2) // G)
    syms = rng.integers(0, S, size=(NL, Tp + 1)).astype(np.int32)
    pair2 = np.ascontiguousarray((syms[:, :-1] * S + syms[:, 1:]).T)
    lens = rng.integers(1, Tp + 1, size=NL).astype(np.int32)
    fixed = [Tp, 1, 2, 3, Tp - 1, L - 1, L, L + 1, 2 * Lh - 1, 2 * Lh, 2 * Lh + 1,
             3 * L + 1, 2 * L - 2, 4 * Lh + 1, Tp + 5]
    lens[:len(fixed)] = fixed
    lens[len(fixed):len(fixed) + 8] |= 1
    a0 = rng.random((2, NL)).astype(np.float32) + 0.1
    return G, pair2, lens[None, :], a0


@pytest.fixture(scope="module", params=SUB_CASES, ids=lambda c: f"Tp{c[0]}-st{c[1]}")
def sub_case(request):
    Tp, st = request.param
    tab = _jax_table()
    G, pair2, lens2, a0 = _sub_stream(Tp, st, seed=Tp)
    tab_ext = np.concatenate([tab, IDENT[None, :]])
    want = np.asarray(jax.jit(JFB._xla_fwd_onehot)(
        jnp.asarray(tab_ext), jnp.asarray(pair2), jnp.asarray(lens2), jnp.asarray(a0).T))
    t = {k: torch.from_numpy(v) for k, v in
         dict(tab=tab, tab_ext=tab_ext, pair2=pair2, lens2=lens2, a0=a0).items()}
    return st, G, want, t


def test_strm_sublanes_plain_equals_b9_sublanes_plain(sub_case, monkeypatch):
    """T2's plain version in sub-lanes is B9's body over the streamed
    matrices: equal to B9's ``_fwd_sublanes_plain`` bit for bit."""
    st, G, want, t = sub_case
    monkeypatch.setattr(TFB, "SUBLANE_T", st)
    al = FC.oh_fwd_strm_plain(FC.mat_streams(t["tab"], t["pair2"]), t["lens2"], t["a0"])
    b9 = TFB._fwd_sublanes_plain(t["pair2"], t["lens2"], t["a0"][None], t["tab_ext"][None], G)[0]
    assert torch.equal(al, b9)
    assert torch.equal(al, TFB.oh_fwd_plain(t["pair2"], t["lens2"], t["a0"], t["tab_ext"]))
    np.testing.assert_allclose(al.numpy(), want, rtol=1e-5)


def test_comp_sublanes_plain_within_gate_of_xla(sub_case, monkeypatch):
    """T3 in sub-lanes: the one chain's alphas in exact arithmetic, within
    the file's tightened gate (1e-5) of ``_xla_fwd_onehot``, and not the
    one chain's bits (the sub-lanes round apart)."""
    st, _, want, t = sub_case
    monkeypatch.setattr(TFB, "SUBLANE_T", st)
    comp = FC.composed_streams(t["tab"], t["pair2"])
    al = FC.oh_fwd_comp_plain(comp, t["lens2"], t["a0"])
    err = _gate(al.numpy(), want)
    assert err < 1e-5, err
    assert not torch.equal(al, FC._comp_chain_plain(comp, t["lens2"], t["a0"]))


def test_comp_sublanes_plain_is_its_phases(sub_case, monkeypatch):
    """``oh_fwd_comp_plain`` in sub-lanes is ``_comp_sublanes_plain`` at
    B9's G; every row past a lane's last valid step repeats that step's
    alpha, and row 0 is the entering vector."""
    st, G, _, t = sub_case
    monkeypatch.setattr(TFB, "SUBLANE_T", st)
    comp = FC.composed_streams(t["tab"], t["pair2"])
    al = FC.oh_fwd_comp_plain(comp, t["lens2"], t["a0"])
    Tp = al.shape[0]
    assert TFB.sublanes(Tp) == G and G in (4, 8)
    assert torch.equal(al, FC._comp_sublanes_plain(comp, t["lens2"], t["a0"], G))
    for name, x in (("T3", al), ("T2", FC.oh_fwd_strm_plain(
            FC.mat_streams(t["tab"], t["pair2"]), t["lens2"], t["a0"]))):
        for n in range(NL):
            last = max(min(int(t["lens2"][0, n]), Tp), 1) - 1
            assert torch.equal(x[last:, :, n], x[last, :, n].expand(Tp - last, 2)), (name, n)
        assert torch.equal(x[0], t["a0"]), name
        assert torch.isfinite(x).all(), name


def test_comp_one_sublane_is_the_one_chain_and_t4(sub_case, monkeypatch):
    """With one sub-lane (SUBLANE_T = Tp) T3's plain version is the one
    chain bit for bit, and T4's equals it (T4's G = 1 is the one chain)."""
    _, _, want, t = sub_case
    Tp = t["pair2"].shape[0]
    monkeypatch.setattr(TFB, "SUBLANE_T", Tp)
    comp = FC.composed_streams(t["tab"], t["pair2"])
    al = FC.oh_fwd_comp_plain(comp, t["lens2"], t["a0"])
    assert torch.equal(al, FC._comp_chain_plain(comp, t["lens2"], t["a0"]))
    sel = FC.oh_fwd_compsel_plain(FC.compsel_index(t["pair2"], S), t["lens2"], t["a0"],
                                  *FC.composed_tables(t["tab"]))
    assert torch.equal(sel, al)
    assert _gate(al.numpy(), want) < 1e-5


def test_cpu_wrappers_take_the_sublane_plain_versions(sub_case, monkeypatch):
    st, G, _, t = sub_case
    monkeypatch.setattr(TFB, "SUBLANE_T", st)
    tab, pair2, lens2, a0 = t["tab"], t["pair2"], t["lens2"], t["a0"]
    mats, comp = FC.mat_streams(tab, pair2), FC.composed_streams(tab, pair2)
    got = FC.oh_fwd_strm(mats, lens2, a0)
    assert torch.equal(got, TFB.fwd_sublanes_plain(FC._mat_steps(mats), pair2.shape[0], lens2,
                                                    a0[None], G)[0])
    assert torch.equal(FC.oh_fwd_comp(comp, lens2, a0),
                       FC._comp_sublanes_plain(comp, lens2, a0, G))
    # T4 runs T3's sub-lanes: equal to T3 at the same G.
    sel = FC.oh_fwd_compsel(FC.compsel_index(pair2, S), lens2, a0, *FC.composed_tables(tab))
    assert torch.equal(sel, FC._comp_sublanes_plain(comp, lens2, a0, G))


def test_compsel_rows_are_t3_streams(sub_case):
    """The rows T4's indices select from its tables (``_gather_comp``) are
    T3's ten streams bit for bit on chained pairs, double step 0's identity
    even half included."""
    _, _, _, t = sub_case
    rows = FC._gather_comp(FC.compsel_index(t["pair2"], S), *FC.composed_tables(t["tab"]))
    assert torch.equal(rows, FC.composed_streams(t["tab"], t["pair2"]))


def test_compsel_sublanes_plain_equals_t3_sublanes_plain(sub_case, monkeypatch):
    """T4's plain version runs T3's sub-lanes at T3's G: bit for bit
    ``_comp_sublanes_plain`` on T3's streams, and within the file's gate
    (1e-5) of ``_xla_fwd_onehot``."""
    st, G, want, t = sub_case
    monkeypatch.setattr(TFB, "SUBLANE_T", st)
    sel = FC.oh_fwd_compsel_plain(FC.compsel_index(t["pair2"], S), t["lens2"], t["a0"],
                                  *FC.composed_tables(t["tab"]))
    comp = FC.composed_streams(t["tab"], t["pair2"])
    assert torch.equal(sel, FC._comp_sublanes_plain(comp, t["lens2"], t["a0"], G))
    err = _gate(sel.numpy(), want)
    assert err < 1e-5, err


def test_compsel_plain_clamps_indices_into_the_tables(sub_case, monkeypatch):
    """Indices outside the tables (negative, past the last row) select the
    first and the last row, as the kernel clamps them, in sub-lanes and in
    one.  The clamp is a guard of the port alone: the JAX bench's
    ``_sel_rows`` selects zero rows there, and ``compsel_index`` never
    makes such an index, so this holds the port against itself."""
    st, _, _, t = sub_case
    tables = FC.composed_tables(t["tab"])
    idx = FC.compsel_index(t["pair2"], S)
    rng = np.random.default_rng(idx.shape[1])
    hit = rng.random(idx.shape) < 0.05
    junk = torch.from_numpy(np.where(hit, rng.integers(-500, 500, size=idx.shape),
                                     idx.numpy()).astype(np.int32))
    lasts = np.array([tables[0].shape[0] - 1, tables[1].shape[0] - 1])[:, None, None]
    clipped = torch.from_numpy(np.clip(junk.numpy(), 0, lasts).astype(np.int32))
    assert not torch.equal(junk, clipped)
    for length in (st, t["pair2"].shape[0]):
        monkeypatch.setattr(TFB, "SUBLANE_T", length)
        got = FC.oh_fwd_compsel_plain(junk, t["lens2"], t["a0"], *tables)
        assert torch.equal(got, FC.oh_fwd_compsel_plain(clipped, t["lens2"], t["a0"], *tables))
        assert torch.isfinite(got).all()


# -- the bench


def test_bench_cpu_run_prints_all_four_variants(capsys):
    assert bench_compose.main(["--device", "cpu", "--chain", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["engine"] == "plain" and line["device"] == "cpu" and line["card"] is None
    assert line["symbols"] == 256 << 10 and line["lane_T"] == 2048
    assert set(line["variants"]) == set(bench_compose.KERNEL_OF)
    for name, v in line["variants"].items():
        assert v["kernel"] == bench_compose.KERNEL_OF[name]
        assert v["gate_err"] < 1e-4 and v["ms"] > 0 and v["bound_ms"] is None
    assert line["variants"]["single"]["gate_err"] == 0.0
    assert line["variants"]["single-strm"]["gate_err"] == 0.0
    assert line["calls"] == {k: 1 + 2 * 3 for k in bench_compose.KERNEL_OF.values()}


def test_bench_default_device_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_compose.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA is not available" in captured.err


def test_bench_bounds_are_the_byte_bounds():
    """At 64 Mi symbols in 1,024 lanes: T1 and T4 move 12 B a symbol, T2 24
    and T3 28, plus the per-lane operands and the tables."""
    Tp, NL = 65536, 1024
    got = {k: bench_compose.bound_ms(k, Tp, NL) for k in bench_compose.KERNEL_OF}
    assert got["single"] == pytest.approx(0.240, abs=1e-3)
    assert got["single-strm"] == pytest.approx(0.481, abs=1e-3)
    assert got["composed"] == pytest.approx(0.561, abs=1e-3)
    assert got["composed-sel"] == pytest.approx(0.240, abs=1e-3)
