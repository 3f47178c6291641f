"""The identity B15 (the dense Viterbi backtrace) rests on, held on the CPU
against the plain one walk and the JAX package.

B15 walks each lane in segments of steps joined by exact K-state maps: what
a run of steps does to the walk's state is a map of the K states onto the K
states, known before the state that enters it, and it packs 3 bits an entry
as a pointer word does.  So each segment's map is walked from all K states
at once, the exit state goes through the maps of the segments above to
each segment's last step, and each segment then walks as the one walk does.
``dense_backtrace_sub_plain`` is that split in plain PyTorch; it must equal
``dense_backtrace_plain`` bit for bit at any segment length (1, 3 and 64
steps, the kernel's own 128, the 129 it lengthens 128 to where 4,097 steps
would need 33 segments, and 256), with 1-step last segments (4,097 steps at
128 and 256, 129 at 128), and the JAX package's ``_pass_backtrace`` on the
same unpacked pointers.  The card tests (tests/test_torch_cuda.py) hold the
kernel to the one walk at the same lengths.

Pointers come from ``dense_backpointers_plain`` over seeded symbol streams
with PAD runs, under seeded random models at K = 2, 5 and 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpgisland_tpu.ops import viterbi_parallel as JVP
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import viterbi_pallas as TVPL

S = 4  # symbols; PAD is S


def _operands(K: int, bk: int, nb: int, seed: int):
    """(bp [bk, nb] packed pointers, exits [nb]) of a seeded K-state model
    over a symbol stream with PAD runs."""
    rng = np.random.default_rng(seed)
    params = HmmParams.from_probs(rng.dirichlet(np.ones(K)),
                                  rng.dirichlet(np.ones(K), size=K),
                                  rng.dirichlet(np.ones(S), size=K))
    steps = rng.integers(0, S, size=(bk, nb)).astype(np.int32)
    for b in range(nb):
        k0 = int(rng.integers(0, bk))
        steps[k0 : k0 + int(rng.integers(1, 300)), b] = S
    v = rng.normal(scale=3.0, size=(K, nb)).astype(np.float32)
    logAT, logB = TVPL._tables(params)
    bp, _, _ = TVPL.dense_backpointers_plain(torch.from_numpy(steps),
                                             torch.from_numpy(v - v.max(0)), logAT, logB)
    return bp, torch.from_numpy(rng.integers(0, K, size=nb).astype(np.int32))


def _jax_path(bp: torch.Tensor, exits: torch.Tensor, K: int) -> np.ndarray:
    """The JAX package's backtrace on the unpacked pointers -> [bk, nb]."""
    unpacked = (bp[:, :, None] >> (3 * torch.arange(K, dtype=torch.int32))) & 7
    flat = jax.jit(JVP._pass_backtrace)(jnp.asarray(unpacked.numpy()),
                                        jnp.asarray(exits.numpy()))
    return np.asarray(flat).reshape(bp.shape[1], bp.shape[0]).T


# (seg, bk): short segments, the kernel's own 128 and its lengthened 129 at
# 4,097 steps, 1-step last segments, one segment, and a lane shorter than
# one segment.
_WALKS = [(1, 40), (3, 40), (64, 4097), (128, 4097), (129, 4097), (256, 4097),
          (128, 129), (3, 130), (64, 64), (128, 7)]


@pytest.mark.parametrize("seg,bk", _WALKS)
@pytest.mark.parametrize("K", [2, 5, 8])
def test_segmented_walk_equals_one_walk(K, seg, bk):
    """The walk in segments of ``seg`` steps equals the one walk bit for
    bit, and the JAX package's."""
    nb = 33 if bk < 1000 else 3
    bp, exits = _operands(K, bk, nb, seed=K * 1000 + seg + bk)
    want = TVPL.dense_backtrace_plain(bp, exits)
    assert torch.equal(TVPL.dense_backtrace_sub_plain(bp, exits, K, seg), want)
    assert np.array_equal(_jax_path(bp, exits, K), want.numpy())


@pytest.mark.parametrize("K", [2, 8])
def test_lengthened_segments_cover_the_lane(K):
    """A lane of 8,192 steps at the kernel's own 128-step segments would
    need 64 segments, more than a block's 32: the kernel lengthens them to
    256 steps.  That walk and the 64-segment one both equal the one walk."""
    bp, exits = _operands(K, 8192, 2, seed=K)
    want = TVPL.dense_backtrace_plain(bp, exits)
    for seg in (128, 256):
        assert torch.equal(TVPL.dense_backtrace_sub_plain(bp, exits, K, seg), want)


def test_wrapper_walk_and_blob():
    """On the CPU B15's wrapper is the one walk at any ``seg``, and the
    pass API carries K in its blob to the backtrace."""
    K = 5
    bp, exits = _operands(K, 300, 9, seed=11)
    want = TVPL.dense_backtrace_plain(bp, exits)
    for seg in (0, 1, 64):
        assert torch.equal(TVPL.dense_backtrace(bp, exits, K, seg), want)
    assert torch.equal(TVPL.pass_backtrace((bp, K), exits), want.T.reshape(-1))
