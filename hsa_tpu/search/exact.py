"""Batched exact-match backward search (BASELINE config 1).

The device analog of the reference's ``bwt_match_exact`` (lineage:
``bwt.c``), restated as a fixed-trip-count ``lax.scan``: all reads in the
batch advance their SA interval one base per step, in lockstep, with masks
for finished/dead lanes (SURVEY.md §7.2.3).

Input layout: reads are *reversed* into processing order (backward search
consumes the read 3'->5') and padded with PAD=5 to a static length.
Code 4 (N) kills the lane (N never matches); PAD lanes carry state through.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import fm

U32 = jnp.uint32
PAD = 5


def pack_reads(reads, max_len: int):
    """Host-side: list of int8 code arrays -> (reads_rev uint8[B,max_len], lens int32[B]).

    Each row is the read reversed (processing order), padded with PAD.
    """
    import numpy as np
    B = len(reads)
    out = np.full((B, max_len), PAD, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        L = min(len(r), max_len)
        out[i, :L] = np.asarray(r, dtype=np.uint8)[::-1][:L]
        lens[i] = L
    return out, lens


def exact_search(idx, reads_rev, lens, init=None):
    """(k, l, matched): SA intervals of each full read; matched=False if absent.

    reads_rev: uint8/int32 [B, Lmax] in processing order, PAD-padded.
    ``init``: optional (k0, l0, alive0) seed state — e.g. K-mer-table
    intervals for the already-consumed prefix (see :func:`kmer_table`).
    """
    B = reads_rev.shape[0]
    if init is None:
        k0 = jnp.zeros(B, dtype=U32)
        l0 = jnp.full(B, idx.n, dtype=U32)
        alive0 = lens > 0
    else:
        k0, l0, alive0 = init

    def step(carry, col):
        k, l, alive = carry
        is_pad = col >= PAD
        is_n = col == 4
        k2, l2 = fm.extend(idx, col.astype(U32), k, l)
        ok = (k2 <= l2) & ~is_n
        upd = alive & ~is_pad
        k = jnp.where(upd, k2, k)
        l = jnp.where(upd, l2, l)
        alive = alive & (is_pad | ok)
        return (k, l, alive), None

    (k, l, alive), _ = lax.scan(step, (k0, l0, alive0), reads_rev.T.astype(jnp.int32))
    return k, l, alive & (k <= l)


def kmer_table(idx, K: int, chunk: int = 1 << 22):
    """SA intervals of every K-mer: (tk, tl) uint32[4^K].

    Index convention matches backward-search consumption order: a pattern
    consumed as c_0, c_1, ... (rightmost character first) has index
    p = sum_t c_t * 4^(K-1-t); empty intervals are the self-propagating
    sentinel (1, 0).  Seeding a segment search with ``tk[p], tl[p]``
    replaces the first K scan steps with one table gather per end.

    HOST-driven BFS (do NOT wrap in jit): tracing all levels into one
    executable keeps every level's intermediates alive at once (4^K
    entries each at the deepest levels).  Each level is its own dispatch
    and the big final levels run in fixed-size chunks.
    """
    import jax
    from .jitcache import split_idx, join_idx

    arrays, meta = split_idx(idx)

    @jax.jit
    def level(arrs, k, l):
        ix = join_idx(meta, arrs)
        ks = jnp.repeat(k, 4)
        ls = jnp.repeat(l, 4)
        # child base via iota, NOT tile(arange(4)): a tiled constant would
        # embed a 4^K-element literal in the HLO
        a = jnp.arange(ks.shape[0], dtype=U32) & U32(3)
        k2, l2 = fm.extend(ix, a, ks, ls)
        empty = k2 > l2
        return jnp.where(empty, U32(1), k2), jnp.where(empty, U32(0), l2)

    k = jnp.zeros(1, U32)
    l = jnp.full(1, jnp.uint32(idx.n), U32)
    step_in = chunk // 4
    for lev in range(K):
        if k.shape[0] <= step_in:
            k, l = level(arrays, k, l)
        else:
            outs = [level(arrays, k[i:i + step_in], l[i:i + step_in])
                    for i in range(0, k.shape[0], step_in)]
            k = jnp.concatenate([o[0] for o in outs])
            l = jnp.concatenate([o[1] for o in outs])
    return k, l


def locate_all(idx, k, l, matched, cap: int):
    """Positions of up to ``cap`` occurrences per read: (pos uint32[B,cap], cnt int32[B]).

    Occurrences beyond ``cap`` are dropped (cnt still reports the true total).
    Unmatched lanes report cnt=0.
    """
    cnt_full = jnp.where(matched, (l - k + U32(1)).astype(jnp.int32), 0)
    take = jnp.minimum(cnt_full, cap)
    offs = jnp.arange(cap, dtype=U32)[None, :]
    ranks = k[:, None] + offs
    valid = offs < take[:, None].astype(U32)
    ranks_flat = jnp.where(valid, ranks, U32(0)).reshape(-1)
    pos = fm.locate(idx, ranks_flat).reshape(ranks.shape)
    # NO_POS sentinel = 0xFFFFFFFE: unreachable as a genome position
    # (the uint32 text bound is 2^32-2).
    pos = jnp.where(valid, pos, U32(0xFFFFFFFE))
    return pos, cnt_full
