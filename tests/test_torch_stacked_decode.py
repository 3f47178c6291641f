"""The stacked reduced decode of the port (kernels B26-B28,
``decode_batch_flat_stacked`` and the mixed-model flush unit
``pipeline._decode_small_batch_stacked``) against the JAX package, and the
decode kernels' pair-table bound.

On the CPU every wrapper takes its plain version, which carries the member
axis through one step loop; the JAX package runs its stacked XLA twins
(``_xla_products_stacked``, ``_xla_backpointers_stacked``,
``_xla_backtrace_bits_stacked``).  Max-plus is adds and maxes only, so the
two agree bit for bit: tables, block products, backpointers, exit deltas,
exit bits, chain maxima, paths and per-record scores.  Each member also
equals the port's own single-model ``decode_batch_flat`` bit for bit.

Member sets: the flagship plus random ``partition=2`` members at K = 8 /
S = 4, and dinuc_cpg plus a random pair member at K = 32 / S = 16 (whose
flat tables hold 288 rows, the kernels' bound), drawn by the JAX package
and carried across as arrays; the random members' states are scrambled,
so every member has its own group table and exit anchors.  Streams at S = 16 are pair recodes of
random bases, so consecutive pairs chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu import pipeline as JPIPE
from cpgisland_tpu.models import presets as JP
from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu.utils import codec as JC
from cpgisland_tpu.utils import profiling
from cpgisland_tpu_torch import pipeline as TPIPE
from cpgisland_tpu_torch.models.hmm import params_from_numpy
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH

# (alphabet, members)
_SETS = [(4, 1), (4, 2), (4, 3), (16, 2)]


def _scrambled(jp, seed):
    """jp with its states renumbered at random: still one-hot in pairs, but
    each symbol's group (and so each pair's exit ids and exit anchor) lies
    elsewhere than in the flagship's layout."""
    perm = np.random.default_rng(seed).permutation(jp.n_states)
    return type(jp)(log_pi=jp.log_pi[perm], log_A=jp.log_A[perm][:, perm],
                    log_B=jp.log_B[perm])


def _members(S, M, seed=0):
    """(JAX params list, port params list) of M members of one alphabet:
    the flagship (or dinuc_cpg) and random partition=2 members with their
    states scrambled."""
    first = JP.durbin_cpg8() if S == 4 else JP.dinuc_cpg()
    jps = [first] + [_scrambled(JP.random_hmm(jax.random.PRNGKey(seed + m), 2 * S, S,
                                              partition=2), seed + m)
                     for m in range(1, M)]
    return jps, [params_from_numpy(p.log_pi, p.log_A, p.log_B) for p in jps]


def _symbols(rng, S, shape):
    """Random symbols of the alphabet; pair recodes of random bases (which
    chain) at S = 16."""
    base = rng.integers(0, 4, size=shape).astype(np.uint8)
    if S == 4:
        return base.astype(np.int32)
    return JC.recode_pairs(base.ravel()).reshape(shape).astype(np.int32)


def _batch(rng, S, N=5, T=300):
    """A ragged [N, T] batch: one record of length 2, one with a mid-record
    PAD run, the rest cut at random lengths."""
    chunks = _symbols(rng, S, (N, T))
    chunks[1, T // 3 : T // 3 + 20] = S
    lengths = rng.integers(T // 2, T + 1, size=N).astype(np.int32)
    lengths[0] = T
    lengths[2] = 2
    return chunks, lengths


# -- kernel level: the plain B26-B28 against the JAX stacked XLA twins --------


@pytest.mark.parametrize("S,M", _SETS)
def test_plain_stacked_kernels_match_xla_twins(rng, S, M):
    """Tables, B26's block products, B27's outputs (both arms) and B28's
    paths bit for bit against the twins on one reset-renumbered stream
    with PAD runs; each member also equals B1 / B2 / B6 / B3 alone."""
    jps, tps = _members(S, M)
    bk, nb = 48, 37
    steps = _symbols(rng, S, (nb, bk)).T.copy()  # consecutive steps of a lane chain
    steps[rng.random((bk, nb)) < 0.05] = S
    rs = rng.random((bk, nb)) < 0.05
    prev0 = int(steps[0, 0]) if steps[0, 0] < S else 0
    jprep = JOH.stacked_prepared(jps, jnp.asarray(steps), prev0, jnp.asarray(rs))
    _, _, jtabs, jids, jpair2, _, _, _ = jprep
    _, _, ttabs, tids, tpair2, _, _, nreal = TOH.stacked_prepared(
        tps, torch.from_numpy(steps), prev0, torch.from_numpy(rs))
    assert nreal == S * S + S and np.array_equal(np.asarray(jpair2), tpair2.numpy())
    for a, b in zip(jtabs + jids, ttabs + tids):
        assert np.array_equal(np.asarray(a), b.numpy())
    tabs, idtabs = torch.stack(ttabs), torch.stack(tids)
    assert tuple(tabs.shape) == (M, S * S + 2 * S, 4)

    red = TOH.oh_products_stacked(tpair2, tabs)
    jred = jax.jit(JOH._xla_products_stacked)(jtabs, jpair2)
    for m in range(M):
        assert np.array_equal(np.asarray(jred[m]).reshape(nb, 4).T, red[m].numpy())
        assert torch.equal(TOH.oh_products(tpair2, tabs[m]), red[m])

    v = rng.normal(scale=2.0, size=(M, nb, 2)).astype(np.float32)
    v_red = torch.from_numpy(v.transpose(0, 2, 1).copy())
    bp, dexit, ebits, dmax = TOH.oh_backpointers_stacked_scores(tpair2, v_red, tabs)
    assert all(torch.equal(a, b) for a, b in zip(
        TOH.oh_backpointers_stacked(tpair2, v_red, tabs), (bp, dexit, ebits)))
    jres = jax.jit(JOH._xla_backpointers_stacked, static_argnums=3)(
        jtabs, [jnp.asarray(x) for x in v], jpair2, True)
    for m, (jdexit, jebits, jbp2, jdmax) in enumerate(jres):
        assert np.array_equal(np.asarray(jbp2), TOH._unpack_words(bp[m]).numpy())
        assert np.array_equal(np.asarray(jdexit).T, dexit[m].numpy())
        assert np.array_equal(np.asarray(jebits), ebits[m].numpy())
        assert np.array_equal(np.asarray(jdmax), dmax[m].numpy())
        single = TOH.oh_backpointers_scores(tpair2, v_red[m].contiguous(), tabs[m])
        assert all(torch.equal(a, b[m]) for a, b in zip(single, (bp, dexit, ebits, dmax)))

    bits = rng.integers(0, 2, size=(M, nb)).astype(np.int32)
    path = TOH.oh_backtrace_stacked(bp, tpair2, idtabs, torch.from_numpy(bits))
    jbits = JOH._xla_backtrace_bits_stacked([r[2] for r in jres],
                                            [jnp.asarray(b) for b in bits])
    for m in range(M):
        ids = np.asarray(jids[m])[np.asarray(jpair2)]
        want = np.where(np.asarray(jbits[m]) == 0, ids[..., 0], ids[..., 1])
        assert np.array_equal(want, path[m].numpy())
        assert torch.equal(TOH.oh_backtrace(bp[m].contiguous(), tpair2, idtabs[m],
                                            torch.from_numpy(bits[m])), path[m])


# -- the library call: decode_batch_flat_stacked -----------------------------


@pytest.mark.parametrize("S,M", _SETS)
def test_decode_batch_flat_stacked_matches_jax(rng, S, M):
    """Paths [M, N, T] and scores [M, N] bit for bit against the JAX
    package's stacked flat decode at the same block (100: the pair rows pad
    to a multiple of 8 in the port), and each member against the port's
    own ``decode_batch_flat``; the path-only call returns the same paths."""
    jps, tps = _members(S, M)
    chunks, lengths = _batch(rng, S)
    jpaths, jscores = JOH.decode_batch_flat_stacked_jit(
        tuple(jps), jnp.asarray(chunks), jnp.asarray(lengths), block_size=100,
        return_score=True)
    tc, tl = torch.from_numpy(chunks), torch.from_numpy(lengths)
    paths, scores = TOH.decode_batch_flat_stacked(tps, tc, tl, block_size=100,
                                                  return_score=True)
    assert paths.shape == (M, 5, 300) and scores.shape == (M, 5)
    assert np.array_equal(np.asarray(jpaths), paths.numpy())
    assert np.array_equal(np.asarray(jscores), scores.numpy())
    for m, p in enumerate(tps):
        own, own_s = TOH.decode_batch_flat(p, tc, tl, block_size=100, return_score=True)
        assert torch.equal(own, paths[m]) and torch.equal(own_s, scores[m])
    assert torch.equal(TOH.decode_batch_flat_stacked(tps, tc, tl, block_size=100), paths)


def test_decode_batch_flat_stacked_default_block_and_prep(rng):
    """``block_size=None`` is 4096 (or the prep's block); a prep built once
    serves the call and gives the same paths."""
    _, tps = _members(4, 2)
    chunks, lengths = _batch(rng, 4, N=3, T=2000)
    tc, tl = torch.from_numpy(chunks), torch.from_numpy(lengths)
    paths = TOH.decode_batch_flat_stacked(tps, tc, tl)
    for m, p in enumerate(tps):
        assert torch.equal(TOH.decode_batch_flat(p, tc, tl), paths[m])
    prep = TOH.prepare_decode_flat(4, tc, tl, 512)
    got = TOH.decode_batch_flat_stacked(tps, tc, tl, prepared=prep)
    assert torch.equal(got, TOH.decode_batch_flat_stacked(tps, tc, tl, block_size=512))


def test_stacked_decode_refuses_mixed_alphabets_and_stale_preps(rng):
    jps4, tps4 = _members(4, 2)
    _, tps16 = _members(16, 1)
    chunks, lengths = _batch(rng, 4)
    tc, tl = torch.from_numpy(chunks), torch.from_numpy(lengths)
    with pytest.raises(ValueError, match="one alphabet"):
        TOH.decode_batch_flat_stacked([tps4[0], tps16[0]], tc, tl, block_size=64)
    with pytest.raises(ValueError, match="at least one member"):
        TOH.decode_batch_flat_stacked([], tc, tl)
    with pytest.raises(ValueError, match="rebuild"):  # another block
        TOH.decode_batch_flat_stacked(tps4, tc, tl, block_size=64,
                                      prepared=TOH.prepare_decode_flat(4, tc, tl, 128))
    with pytest.raises(ValueError, match="rebuild"):  # another batch
        TOH.decode_batch_flat_stacked(tps4, tc[:3], tl[:3], block_size=64,
                                      prepared=TOH.prepare_decode_flat(4, tc, tl, 64))
    with pytest.raises(ValueError, match="at least 2 symbols"):
        TOH.decode_batch_flat_stacked(tps4, tc[:, :1], tl, block_size=64)
    steps = torch.from_numpy(_symbols(rng, 4, (16, 8)))
    resets = torch.zeros((16, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="renumbering"):  # prep without the resets
        TOH.stacked_prepared(tps4, steps, 0, resets, pre=TOH.prepare_pairs(4, steps, 0))
    with pytest.raises(ValueError, match="renumbering"):  # prep with them
        TOH.stacked_prepared(tps4, steps, 0, None, pre=TOH.prepare_pairs(4, steps, 0, resets))
    # The JAX package refuses the same mixed cast.
    with pytest.raises(ValueError, match="one alphabet"):
        JOH.stacked_prepared([jps4[0], JP.dinuc_cpg()], jnp.asarray(steps.numpy()), 0)


# -- the decode kernels' pair-table bound (S <= 16 with record resets) --------


def test_decode_wrappers_refuse_tables_past_the_bound():
    """A table past MAX_PAIRS = 288 rows (16 symbols with resets) raises a
    ValueError naming the bound in every decode wrapper, single and
    stacked, before any launch; an empty member stack raises too."""
    assert TOH.MAX_PAIRS == 288
    bk, nb, nP = 8, 3, 289
    pair2 = torch.zeros((bk, nb), dtype=torch.int32)
    tab = torch.zeros((nP, 4), dtype=torch.float32)
    idtab = torch.zeros((nP, 2), dtype=torch.int32)
    v = torch.zeros((2, nb), dtype=torch.float32)
    bp = torch.zeros((bk // 8, nb), dtype=torch.int32)
    bits = torch.zeros((nb,), dtype=torch.int32)
    calls = [
        lambda: TOH.oh_products(pair2, tab),
        lambda: TOH.oh_backpointers(pair2, v, tab),
        lambda: TOH.oh_backpointers_scores(pair2, v, tab),
        lambda: TOH.oh_backtrace(bp, pair2, idtab, bits),
        lambda: TOH.oh_products_stacked(pair2, tab[None]),
        lambda: TOH.oh_backpointers_stacked(pair2, v[None], tab[None]),
        lambda: TOH.oh_backpointers_stacked_scores(pair2, v[None], tab[None]),
        lambda: TOH.oh_backtrace_stacked(bp[None], pair2, idtab[None], bits[None]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="at most 288"):
            call()
    with pytest.raises(ValueError, match="at least one member"):
        TOH.oh_products_stacked(pair2, tab[:0, :][None][:0])
    with pytest.raises(ValueError, match=r"\[M, nP, 4\]"):
        TOH.oh_products_stacked(pair2, tab)


def test_dinuc_flat_decode_at_the_bound_matches_jax(rng):
    """dinuc_cpg's flat tables hold exactly 288 rows: the single-model flat
    decode (B1, B6, B3) runs there and equals the JAX package's bit for
    bit, paths and scores."""
    jp, tp = JP.dinuc_cpg(), _members(16, 1)[1][0]
    chunks, lengths = _batch(rng, 16)
    jpaths, jscores = jax.jit(lambda c, n: JOH.decode_batch_flat(
        jp, c, n, block_size=64, return_score=True))(jnp.asarray(chunks), jnp.asarray(lengths))
    paths, scores = TOH.decode_batch_flat(tp, torch.from_numpy(chunks),
                                          torch.from_numpy(lengths), block_size=64,
                                          return_score=True)
    assert np.array_equal(np.asarray(jpaths), paths.numpy())
    assert np.array_equal(np.asarray(jscores), scores.numpy())


# -- the flush unit: pipeline._decode_small_batch_stacked --------------------


def _records(rng, n):
    """n named records of 300-3000 bases with a planted GC-rich stretch."""
    out = []
    for i in range(n):
        size = int(rng.integers(300, 3000))
        s = rng.choice(4, size=size, p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
        lo = int(rng.integers(0, size // 2))
        s[lo : lo + size // 3] = rng.choice(4, size=len(s[lo : lo + size // 3]),
                                           p=[0.1, 0.4, 0.4, 0.1])
        out.append((f"r{i}", s))
    return out


@pytest.mark.parametrize("M,islands", [(2, "device"), (2, "host"), (3, "mixed")])
def test_decode_small_batch_stacked_matches_jax(rng, M, islands):
    """Island calls of every record equal the JAX flush unit's on the same
    batch and owners (round-robin), with device islands (the plain island
    engine on the CPU), host islands, or a mix (one model through the
    observation caller); the phases land in the dict."""
    jps, tps = _members(4, M)
    batch = _records(rng, 7)
    owners = [i % M for i in range(len(batch))]
    use_dev = {"device": [True] * M, "host": [False] * M,
               "mixed": [True, False, True][:M]}[islands]
    isl = [None] * M
    if islands == "mixed":
        isl[1] = (0, 1, 2, 3)
    kw = dict(min_len=50, island_states_list=isl, use_device_list=use_dev)
    jB, jparts = JPIPE._decode_small_batch_stacked(
        list(jps), batch, owners, cap_boxes=[[1024] for _ in range(M)],
        timer=profiling.PhaseTimer(), **kw)
    phases = {}
    tB, tparts = TPIPE._decode_small_batch_stacked(
        tps, batch, owners, cap_boxes=[[1024] for _ in range(M)], phases=phases, **kw)
    assert jB == tB == len(batch) and set(phases) == {"decode", "islands"}
    assert sum(len(p) for p in tparts) > 0
    for j, t in zip(jparts, tparts):
        assert j.format_lines() == t.format_lines()
        assert np.array_equal(j.beg, t.beg) and np.array_equal(j.end, t.end)
