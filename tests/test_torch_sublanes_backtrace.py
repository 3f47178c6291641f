"""The identities B3 / B28 and B1 / B26 rest on, held on the CPU against the
plain versions and the JAX package.

B3 / B28 (the reduced backtrace) walk each lane in segments of packed words
joined by exact bits: what a run of words does to the walk's bit is a map
{0, 1} -> {0, 1} known before the bit that enters it, so each segment's map
is walked from both bits at once, the exit bit goes through the maps of the
segments above to each segment's last step, and each segment then walks as
the one walk does.  ``oh_backtrace_stacked_sub_plain`` is that split in
plain PyTorch; it must equal ``oh_backtrace_stacked_plain`` bit for bit at
any segment length (1, 3 and 64 words, and the kernels' own 16, 17 and 32
words, with a 1-word last segment at bk = 4,104), and at M = 1 the JAX
package's ``_xla_backtrace``.  The card tests (tests/test_torch_cuda.py)
hold the kernels to the one walk at the same lengths.

B1 / B26 run one row of the 2x2 max-plus product a thread: row i of the
product reads only row i, and is the backpointer chain's delta recursion
entered at the identity's row i, (0, LOG_ZERO) or (LOG_ZERO, 0).  Each row
of ``oh_products_stacked_plain`` must equal ``_backpointers_chain``'s exit
pair from that entry bit for bit, and each member the JAX package's
``_xla_products``.

Operands: the flagship (S = 4) or dinuc_cpg (S = 16) plus random
partition=2 members (tests/test_torch_stacked_decode.py), streams with
scattered PADs, PAD runs and record resets, pointers from the plain chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.ops import viterbi_onehot as JOH
from cpgisland_tpu_torch.models.hmm import LOG_ZERO
from cpgisland_tpu_torch.ops import viterbi_onehot as TOH

from test_torch_stacked_decode import _members, _symbols


def _operands(S: int, M: int, bk: int, nb: int, seed: int):
    """(pair2 [bk, nb], tabs, idtabs, bp [M, bk/8, nb], exit bits [M, nb])
    of a reset-renumbered stream with scattered PADs and PAD runs."""
    rng = np.random.default_rng(seed)
    _, tps = _members(S, M, seed)
    steps = np.ascontiguousarray(_symbols(rng, S, (nb, bk)).T)
    steps[rng.random((bk, nb)) < 0.03] = S
    for b in range(0, nb, 3):  # a PAD run in every third lane
        k0 = int(rng.integers(0, bk))
        steps[k0 : k0 + int(rng.integers(1, 60)), b] = S
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01)
    _, _, tabs, idtabs, pair2, _, e_out, nreal = TOH.stacked_prepared(
        tps, torch.from_numpy(steps), int(rng.integers(0, S)), resets)
    pair2 = TOH._pad_pair_rows(pair2, e_out, nreal)
    tabs, idtabs = torch.stack(tabs), torch.stack(idtabs)
    v = torch.from_numpy(rng.normal(scale=2.0, size=(M, 2, nb)).astype(np.float32))
    bp = TOH.oh_backpointers_stacked_plain(pair2, v, tabs)[0]
    bits = torch.from_numpy(rng.integers(0, 2, size=(M, nb)).astype(np.int32))
    return pair2, tabs, idtabs, bp, bits


def _jax_path(bp, pair2, idtab, bits):
    """The JAX package's single-model backtrace on one member's operands."""
    bp2 = jnp.asarray(TOH._unpack_words(bp).numpy())
    return np.asarray(jax.jit(JOH._xla_backtrace)(bp2, jnp.asarray(pair2.numpy()),
                                                  jnp.asarray(idtab.numpy()),
                                                  jnp.asarray(bits.numpy())))


_NBS, _MS, _SS = (1, 33, 129), (1, 2, 5), (4, 16)
# Every segment length at every bk (a 1-word last segment at 4,104 steps;
# 16 and 17 words are the kernels' own at 4,096 and 4,104 steps, 32 on many
# lanes), nb, M and S taken in turn; then every nb x M x S at one small bk.
_WALKS = ([(seg, bk, _NBS[i % 3], _MS[(i // 3) % 3], _SS[i % 2])
           for i, (seg, bk) in enumerate((seg, bk) for seg in (1, 3, 64, 16, 17, 32)
                                         for bk in (8, 24, 40, 4096, 4104))]
          + [(1, 24, nb, M, S) for nb in _NBS for M in _MS for S in _SS])


@pytest.mark.parametrize("seg,bk,nb,M,S", _WALKS)
def test_segmented_walk_equals_one_walk(seg, bk, nb, M, S):
    """The walk in segments of ``seg`` words equals the one walk bit for
    bit (and at M = 1 the JAX package's)."""
    pair2, _, idtabs, bp, bits = _operands(S, M, bk, nb, seed=seg * 7 + bk + nb + M + S)
    want = TOH.oh_backtrace_stacked_plain(bp, pair2, idtabs, bits)
    assert torch.equal(TOH.oh_backtrace_stacked_sub_plain(bp, pair2, idtabs, bits, seg), want)
    if M == 1:
        assert np.array_equal(_jax_path(bp[0], pair2, idtabs[0], bits[0]), want[0].numpy())


@pytest.mark.parametrize("S,M,bk,nb", [(4, 1, 8, 1), (4, 2, 40, 33), (16, 2, 24, 129),
                                       (4, 5, 520, 65), (16, 3, 104, 31)])
def test_product_rows_are_the_backpointer_chain(S, M, bk, nb):
    """Row i of each member's block product is the delta recursion entered
    at (0, LOG_ZERO) or (LOG_ZERO, 0), bit for bit, and each member's
    product equals the JAX package's ``_xla_products``."""
    pair2, tabs, _, _, _ = _operands(S, M, bk, nb, seed=S + M + bk + nb)
    red = TOH.oh_products_stacked_plain(pair2, tabs)
    assert red.shape == (M, 4, nb)
    for i, entry in enumerate(((0.0, LOG_ZERO), (LOG_ZERO, 0.0))):
        v = torch.tensor(entry, dtype=torch.float32)[None, :, None].expand(M, 2, nb)
        dexit = TOH._backpointers_chain(pair2, v.contiguous(), tabs, want_dmax=False)[1]
        assert torch.equal(red[:, 2 * i : 2 * i + 2], dexit)
    jpair2 = jnp.asarray(pair2.numpy())
    for m in range(M):
        jred = jax.jit(JOH._xla_products)(jnp.asarray(tabs[m].numpy()), jpair2)
        assert np.array_equal(np.asarray(jred).reshape(nb, 4).T, red[m].numpy())
