"""Batched FM-index primitives over the fused rank-indexed layout (jnp).

These are the device analogs of the reference's ``bwt.c`` rank/locate
primitives (``bwt_occ4``/``bwt_2occ4``/``bwt_sa``), restated over
``hsa_tpu.index.layout`` v4 rows and batched over query vectors.

Structure:

- hot loops live in ``lax.scan``/``fori_loop`` executables with the table
  as a jit ARGUMENT.
- v4 fuses occ checkpoints, BWT symbols, locate mark bits and the
  mark-rank checkpoint into ONE 32-byte row per 32 ranks, so ``lf`` — and
  every locate-walk step — costs exactly one row gather.
- decode compute is elementwise on FLAT [B] vectors; the 32-rank block
  needs only two 16-symbol mask words per count.

Rank convention (matches :mod:`hsa_tpu.fmcore`): the primitive is
``occ_lt(a, p)`` = number of ``a`` among bwt_full rows ``[0, p)`` excluding
the primary row, for p in [0, n+1].  Backward extension of [k, l] with
base a::

    k' = C[a] + occ_lt(a, k)
    l' = C[a] + occ_lt(a, l + 1) - 1

All ranks are uint32 (genome bound 4.3 Gbp, SURVEY.md §7.2).

The v4 rows are indexed by RANK (not stored-BWT position): the primary
rank occupies a slot whose symbol is a dummy 0; checkpoints count stored
symbols only, and in-block counts of base 0 spanning the primary slot are
corrected with the statically-known primary position.

Index sharding (BASELINE configs 4-5): when the ``idx`` namespace carries a
``shard_axis`` name (set inside ``shard_map`` by ``hsa_tpu.dist``), the
occ/sample arrays are *local row ranges* of the global tables and every
primitive follows the masked-gather + ``psum`` pattern: the owning shard
contributes the real value, all others contribute zero, and a psum over
the shard axis merges — the "all-gather interval merge" of the north star,
expressed per-query.  The same code runs unsharded when ``shard_axis`` is
None.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

U32 = jnp.uint32
I32 = jnp.int32
_PAT55 = 0x55555555


def _gather_rows(idx, blocks, b_global, offset_attr):
    """Row gather by global block id -> (rows [B, 8], own mask [B] | None).

    On sharded indexes ``own`` marks lanes whose block this shard owns;
    callers must gate every value derived from non-owned rows with ``own``
    before the psum merge.  Unsharded: own is None.  The barrier keeps the
    gather on XLA's fast standalone lowering.
    """
    ax = getattr(idx, "shard_axis", None)
    b_global = b_global.astype(I32)
    if ax is None:
        return lax.optimization_barrier(jnp.take(blocks, b_global, axis=0)), None
    off = getattr(idx, offset_attr)
    local = b_global - off
    own = (local >= 0) & (local < blocks.shape[0])
    rows = jnp.take(blocks, jnp.clip(local, 0, blocks.shape[0] - 1), axis=0)
    return lax.optimization_barrier(rows), own


def _psum(idx, x):
    ax = getattr(idx, "shard_axis", None)
    return lax.psum(x, ax) if ax is not None else x


def _word_masks(off):
    """Two flat uint32 masks; mask j selects the 2-bit symbol pairs of word
    4+j that lie below prefix length ``off`` (off int32 [B] in [0, 32])."""
    PAT = U32(_PAT55)
    ms = []
    rem = off
    for _ in range(2):
        v = jnp.where(rem < 16, rem, 16)
        rem = rem - v
        sh = U32(2) * (U32(16) - jnp.where(v > 1, v, 1).astype(U32))
        ms.append(jnp.where(v > 0, PAT >> sh, U32(0)))
    return ms


def _count_base(rows, ms, a):
    """Flat in-block match count of base ``a`` (int or flat uint32 [B])."""
    PAT = U32(_PAT55)
    if isinstance(a, int):
        aa = U32(a)
    else:
        aa = a.astype(U32)
    tot = None
    for j in range(2):
        x = rows[:, 4 + j] ^ (aa * PAT)
        e = (~x) & ((~x) >> U32(1)) & ms[j]
        c = lax.population_count(e)
        tot = c if tot is None else tot + c
    return tot


def _primary_corr(idx, b, off, *, rev: bool):
    """1 where the primary's dummy slot falls inside [32b, 32b+off), else 0.

    In-block counts of base 0 must subtract this (the dummy symbol is 0).
    b/off are flat int32 [B]; primary is a trace-time scalar.
    """
    primary = int(idx.rev_primary if rev else idx.primary)
    p_blk, p_off = primary >> 5, primary & 31
    return ((b == p_blk) & (off > p_off)).astype(U32)


def _select4(rows, a, base_col=0):
    """Flat 4-way column select: rows[:, base_col + a] for a uint32/int32 [B]."""
    a = a.astype(I32)
    r01 = jnp.where(a < 1, rows[:, base_col + 0], rows[:, base_col + 1])
    r23 = jnp.where(a < 3, rows[:, base_col + 2], rows[:, base_col + 3])
    return jnp.where(a < 2, r01, r23)


def _sym_at(rows, off):
    """2-bit symbol of rank slot ``off`` (int32 [B] in [0, 31]) — dummy 0 at
    the primary slot."""
    word = jnp.where(off < 16, rows[:, 4], rows[:, 5])
    return (word >> (U32(2) * (off & 15).astype(U32))) & U32(3)


def _row_decode(idx, p, *, rev: bool = False):
    """(rows [B,8], b, off int32 [B], own [B]|None) for prefix lengths p."""
    blocks = idx.rev_occ_blocks if rev else idx.occ_blocks
    offset_attr = "rev_row_offset" if rev else "row_offset"
    p = p.astype(U32)
    b = (p >> U32(5)).astype(I32)
    off = (p & U32(31)).astype(I32)
    rows, own = _gather_rows(idx, blocks, b, offset_attr)
    return rows, b, off, own


def occ_lt4(idx, p):
    """[B,4] counts of each base among bwt_full rows [0, p). p: uint32[B]."""
    rows, b, off, own = _row_decode(idx, p)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=False)
    outs = []
    for a in range(4):
        tot = rows[:, a] + _count_base(rows, ms, a)
        if a == 0:
            tot = tot - corr
        if own is not None:
            tot = tot * own.astype(U32)
        outs.append(tot)
    return _psum(idx, jnp.stack(outs, axis=1))


def occ_lt4_flat(idx, p):
    """Tuple of 4 flat [B] counts (same values as occ_lt4 columns).

    Sharded: ONE stacked psum for all four bases (coalesced per-step
    merge — the collective count per beam step is O(1), not O(bases))."""
    rows, b, off, own = _row_decode(idx, p)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=False)
    outs = []
    for a in range(4):
        tot = rows[:, a] + _count_base(rows, ms, a)
        if a == 0:
            tot = tot - corr
        if own is not None:
            tot = tot * own.astype(U32)
        outs.append(tot)
    merged = _psum(idx, jnp.stack(outs, axis=0))
    return tuple(merged[a] for a in range(4))


def occ_lt(idx, a, p, *, rev: bool = False):
    """[B] count of base a[B] among bwt_full rows [0, p). a must be 0..3."""
    rows, b, off, own = _row_decode(idx, p, rev=rev)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=rev)
    res = (_select4(rows, a) + _count_base(rows, ms, a)
           - jnp.where(a.astype(U32) == 0, corr, U32(0)))
    if own is not None:
        res = res * own.astype(U32)
    return _psum(idx, res)


def extend(idx, a, k, l, *, rev: bool = False):
    """Left-extend [k,l] with base a (uint32 vectors). Empty iff k' > l'.

    Callers must mask lanes where a > 3 themselves (N never matches).
    Both interval ends go through ONE concatenated row gather (larger
    gathers sit higher on the take() saturation curve).
    """
    a = jnp.minimum(a, 3).astype(U32)
    B = k.shape[0]
    o = occ_lt(idx, jnp.concatenate([a, a]),
               jnp.concatenate([k, l + U32(1)]), rev=rev)
    Ca = jnp.take(idx.C, a.astype(I32))
    return Ca + o[:B], Ca + o[B:] - U32(1)


def extend4(idx, k, l):
    """All-bases extension: ([B,4] k', [B,4] l') — the ``bwt_2occ4`` analog."""
    o_k = occ_lt4(idx, k)
    o_l = occ_lt4(idx, l + U32(1))
    C4 = idx.C[None, 0:4]
    return C4 + o_k, C4 + o_l - U32(1)


def extend4_flat(idx, k, l):
    """Flat all-bases extension: two tuples of 4 [B] vectors (k'_a, l'_a).

    One concatenated row gather serves both interval ends.
    """
    B = k.shape[0]
    o = occ_lt4_flat(idx, jnp.concatenate([k, l + U32(1)]))
    ks, ls = [], []
    for a in range(4):
        Ca = idx.C[a]
        ks.append(Ca + o[a][:B])
        ls.append(Ca + o[a][B:] - U32(1))
    return tuple(ks), tuple(ls)


def bwt_char(idx, r):
    """bwt_full symbol at rank r (garbage at r == primary; mask there)."""
    rows, b, off, own = _row_decode(idx, r)
    sym = _sym_at(rows, off)
    if own is not None:
        sym = sym * own.astype(U32)
    return _psum(idx, sym)


def _lf_from_rows(idx, rows, b, off, r):
    """LF mapping decoded from already-gathered rows of ranks r."""
    c = _sym_at(rows, off)
    # occ_lt(c, r+1) = ckpt[c] + in-block matches among slots [0, off+1)
    ms = _word_masks(off + 1)
    corr = _primary_corr(idx, b, off + 1, rev=False)
    occ = (_select4(rows, c) + _count_base(rows, ms, c)
           - jnp.where(c == U32(0), corr, U32(0)))
    res = jnp.take(idx.C, c.astype(I32)) + occ - U32(1)
    return jnp.where(r == idx.primary, U32(0), res)


def lf(idx, r):
    """LF mapping; LF(primary) = 0.  ONE row gather total."""
    rows, b, off, own = _row_decode(idx, r)
    res = _lf_from_rows(idx, rows, b, off, r)
    if own is not None:
        res = res * own.astype(U32)
    return _psum(idx, res)


def _mark_from_rows(rows, off):
    """(is_marked [B] uint32, mark_rank [B] uint32) from fused rows."""
    bit = (rows[:, 6] >> off.astype(U32)) & U32(1)
    below = ((U32(1) << off.astype(U32)) - U32(1)) & rows[:, 6]
    mrank = rows[:, 7] + lax.population_count(below)
    return bit, mrank


def _sample_lookup(idx, mrank):
    ax = getattr(idx, "shard_axis", None)
    mrank = mrank.astype(I32)
    if ax is None:
        return lax.optimization_barrier(jnp.take(idx.samples, mrank))
    off = idx.sample_offset
    local = mrank - off
    own = (local >= 0) & (local < idx.samples.shape[0])
    val = jnp.take(idx.samples, jnp.clip(local, 0, idx.samples.shape[0] - 1))
    return lax.psum(val * own.astype(val.dtype), ax)


def locate(idx, r):
    """Text positions of ranks r[B].

    With a direct suffix array (``idx.sa_direct``, small-genome indexes)
    this is ONE gather; otherwise the bounded LF-walk (<= sa_intv-1
    steps, one fused-row gather per step — mark + LF from the same row —
    plus one sample gather per lane at its mark step)."""
    sad = getattr(idx, "sa_direct", None)
    if sad is not None:
        ax = getattr(idx, "shard_axis", None)
        ri = r.astype(I32)
        if ax is None:
            return lax.optimization_barrier(jnp.take(sad, ri))
        off = idx.sa_offset
        local = ri - off
        own = (local >= 0) & (local < sad.shape[0])
        val = jnp.take(sad, jnp.clip(local, 0, sad.shape[0] - 1))
        return lax.psum(val * own.astype(val.dtype), ax)
    B = r.shape[0]
    pos = jnp.zeros(B, dtype=U32)
    steps = jnp.zeros(B, dtype=U32)
    done = jnp.zeros(B, dtype=bool)

    def body(i, carry):
        r, steps, pos, done = carry
        rows, b, off, own = _row_decode(idx, r)
        bit, mrank = _mark_from_rows(rows, off)
        r_next = _lf_from_rows(idx, rows, b, off, r)
        if own is not None:
            o = own.astype(U32)
            # one coalesced psum per walk step for all three fields
            bit, mrank, r_next = _psum(
                idx, jnp.stack([bit * o, mrank * o, r_next * o], axis=0))
        m = bit == U32(1)
        newly = m & ~done
        pos = jnp.where(newly, _sample_lookup(idx, mrank) + steps, pos)
        done = done | m
        r = jnp.where(done, r, r_next)
        steps = jnp.where(done, steps, steps + U32(1))
        return (r, steps, pos, done)

    r, steps, pos, done = lax.fori_loop(0, idx.sa_intv, body, (r, steps, pos, done))
    return pos
