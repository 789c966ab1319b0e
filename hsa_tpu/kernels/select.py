"""Top-K selection for the beam engine.

Layout contract: candidate matrices are **[C, B]** — candidate slots on
rows, reads on columns.  Keys embed ``score << KEY_SH | column`` with the
column unique per read, so the selected set and its order are fully
determined without a stable sort.  SENT (0x7FFF0000) marks invalid slots.

The selection is one multi-operand ``lax.sort`` over the minor axis of the
transposed ``[B, C]`` matrices, left to XLA.  In the beam ladder on the
H100 it ran 1.6-2.0x faster than the same sort over axis 0 of ``[C, B]``;
``lax.top_k`` was 10% faster on the (8, 64) ladder and up to 10% slower on
the widest-rung flush shapes (``benchmarks/select_layouts.py``, PERF.md).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32

KEY_SH = 14                      # key = score << KEY_SH | column
SENT = np.uint32(0x7FFF0000)     # invalid-key sentinel
SCORE_CAP = int(SENT) >> KEY_SH  # scores at/above this are "no hit"


def select_topk(key, payloads, K: int, window=None, drop_accum=None):
    """Top-K smallest-key rows of [C, B] matrices.

    key:      uint32 [C, B], SENT where invalid, unique keys per column
              (embed the row index in the low KEY_SH bits)
    payloads: tuple of uint32 [C, B] carried along with the keys
    window:   optional uint32 [B] or [1, B] max allowed score; key rows
              whose score field exceeds it are invalidated first
    drop_accum: optional uint32 [1, B] running drop counter; the returned
              counter is drop_accum + this call's drops
    Returns (okeyd [K+1, B] uint32 — rows 0..K-1 the selected keys in
    ascending order, row K the drop counter —, payload outs tuple [K, B],
    ndrop [1, B] view of row K).  A drop is a valid row beyond the K kept.
    """
    C, B = key.shape
    if window is not None:
        win = window.astype(U32).reshape(1, B)
        key = jnp.where((key >> KEY_SH) > win, SENT | key, key)
    nvalid = (key < SENT).sum(axis=0, dtype=I32)
    nd = jnp.maximum(nvalid - K, 0).astype(U32).reshape(1, B)
    if drop_accum is not None:
        nd = drop_accum.astype(U32).reshape(1, B) + nd
    sk, *pouts = jax.lax.sort((key.T, *(p.T for p in payloads)),
                              dimension=1, num_keys=1)
    okeyd = jnp.concatenate([sk[:, :K].T, nd], axis=0)
    return okeyd, tuple(p[:, :K].T for p in pouts), nd
