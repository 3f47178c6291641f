"""Input layouts of the whole-sequence trainers, on one device.

Counterpart of ``cpgisland_tpu/parallel/fb_sharded.py``, cut to the
one-device forms of its two layout helpers: :func:`shard_sequence` (one
symbol stream padded to a block multiple, ``SeqBackend``) and
:func:`pad_batch2d` (a batch of whole sequences padded for a data x seq
split, ``Seq2DBackend``).  The sequence-parallel bodies and their
cross-device boundary exchange wait for the multi-device port (ROADMAP
A9); with one device the exchange is the identity.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BLOCK = 1024


def shard_sequence(obs: np.ndarray, n_shards: int, block_size: int = DEFAULT_BLOCK,
                   pad_value: int = 4):
    """Split one symbol stream into per-device shards (padded, with
    lengths): (obs_padded [n_shards * L] uint8, lengths [n_shards] int32),
    L a multiple of ``block_size``."""
    obs = np.ascontiguousarray(obs, dtype=np.uint8)
    T = obs.shape[0]
    quantum = n_shards * block_size
    padded_T = max(quantum, ((T + quantum - 1) // quantum) * quantum)
    if padded_T != T:
        obs = np.concatenate([obs, np.full(padded_T - T, pad_value, dtype=np.uint8)])
    L = padded_T // n_shards
    lengths = np.clip(T - np.arange(n_shards) * L, 0, L).astype(np.int32)
    return obs, lengths


def pad_batch2d(chunks: np.ndarray, lengths: np.ndarray, dp: int, sp: int, block_size: int,
                pad_value: int):
    """Pad an [N, T] sequence batch for a dp x sp split: rows to a multiple
    of dp with zero-length rows, columns to a multiple of sp * block_size
    with ``pad_value``.  Returns the inputs themselves when no padding is
    needed."""
    chunks = np.asarray(chunks)
    lengths = np.asarray(lengths)
    n, T = chunks.shape
    quantum = sp * block_size
    T_pad = max(quantum, -(-T // quantum) * quantum)
    n_pad = -(-n // dp) * dp
    if (n_pad, T_pad) == (n, T):
        return chunks, lengths.astype(np.int32)
    obs = np.full((n_pad, T_pad), pad_value, dtype=np.uint8)
    obs[:n, :T] = chunks
    out_lengths = np.zeros(n_pad, np.int32)
    out_lengths[:n] = lengths
    return obs, out_lengths
