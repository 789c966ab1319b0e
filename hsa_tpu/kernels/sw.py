"""Batched glocal (fit-in-window) affine-gap DP — the mate-rescue screen.

Replaces the reference's per-pair ``stdaln.c`` banded Smith-Waterman calls
(lineage: ``bwape.c:bwa_paired_sw``) with a batched, vectorized min-cost
DP: hundreds of (read, window) pairs advance one DP row per step, columns
fully vectorized.  The affine *horizontal* (deletion) recurrence — a
sequential dependency in the textbook formulation — is restated as an
exclusive prefix-min::

    dele[i][j] = j*gape + min_{j' < j} (m[i][j'] - j'*gape + gapo - gape)

(the ``-gape`` makes a length-g gap cost gapo + (g-1)*gape)

so one row update is pure vector ops plus one cumulative min
(``associative_scan``).

The screen returns only (cost, end_column): traceback for the few accepted
rescues runs on the host over a tiny window slice
(``hsa_tpu.resolve.sampe.fit_in_window``, which is the semantics oracle
for this screen — tested cost-equal).

Semantics: full read aligned, window start/end free, costs (s_mm per
mismatch, s_gapo + (g-1)*s_gape per gap of length g), read code 4 (N)
mismatches everything.  Rows beyond ``lens`` and columns beyond ``wlens``
are masked.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

I32 = jnp.int32
BIG = 1 << 28


def _row_update(m, ins, dele, m0, ins0, sub, col_ok, gape_ramp,
                s_gapo, s_gape, G):
    """One DP row. Arrays [R, G] cover columns 1..G; (m0, ins0) are column 0."""
    R = m.shape[0]
    big_col = jnp.full((R, 1), BIG, I32)
    pm = jnp.concatenate([m0[:, None], m[:, :-1]], axis=1)
    pi = jnp.concatenate([ins0[:, None], ins[:, :-1]], axis=1)
    pd = jnp.concatenate([big_col, dele[:, :-1]], axis=1)
    best_prev = jnp.minimum(jnp.minimum(pm, pi), pd)
    m_new = jnp.where(col_ok, best_prev + sub, BIG)
    ins_new = jnp.minimum(m + s_gapo, ins + s_gape)
    ins0_new = jnp.minimum(m0 + s_gapo, ins0 + s_gape)
    # deletions: exclusive prefix-min; constant (gapo - gape) makes a
    # length-g gap cost gapo + (g-1)*gape
    c = m_new - gape_ramp + (s_gapo - s_gape)
    cm = lax.associative_scan(jnp.minimum, c, axis=1)
    cm_excl = jnp.concatenate([big_col, cm[:, :-1]], axis=1)
    dele_new = jnp.where(col_ok, cm_excl + gape_ramp, BIG)
    m0_new = jnp.full((R,), BIG, I32)  # column 0 is only free on row 0
    return m_new, ins_new, dele_new, m0_new, ins0_new


def glocal_screen(reads, lens, windows, wlens, s_mm: int, s_gapo: int,
                  s_gape: int):
    """jnp reference: (cost[R] int32, end[R] int32) of the best placement.

    reads: int32[R, L] codes (0..4; pad arbitrary beyond lens)
    windows: int32[R, G] codes (0..3; pad arbitrary beyond wlens)
    ``end`` is the window column (0-based exclusive end) of the best
    alignment; cost >= BIG means no placement.
    """
    reads = reads.astype(I32)
    windows = windows.astype(I32)
    R, L = reads.shape
    G = windows.shape[1]
    cols = jnp.arange(1, G + 1, dtype=I32)[None, :]          # [1, G]
    col_ok = cols <= wlens[:, None]                          # [R, G]
    gape_ramp = cols * s_gape

    m = jnp.zeros((R, G), I32)           # row 0: free start at every column
    ins = jnp.full((R, G), BIG, I32)
    dele = jnp.full((R, G), BIG, I32)
    m0 = jnp.zeros((R,), I32)
    ins0 = jnp.full((R,), BIG, I32)

    def row(carry, i):
        m, ins, dele, m0, ins0 = carry
        rb = jnp.take_along_axis(reads, jnp.full((R, 1), i, I32), axis=1)
        sub = jnp.where((rb <= 3) & (rb == windows), 0, s_mm)
        active = (i < lens)[:, None]
        outs = _row_update(m, ins, dele, m0, ins0, sub, col_ok, gape_ramp,
                           s_gapo, s_gape, G)
        m2, ins2, dele2, m02, ins02 = outs
        m = jnp.where(active, m2, m)
        ins = jnp.where(active, ins2, ins)
        dele = jnp.where(active, dele2, dele)
        act0 = i < lens
        m0 = jnp.where(act0, m02, m0)
        ins0 = jnp.where(act0, ins02, ins0)
        return (m, ins, dele, m0, ins0), None

    (m, ins, dele, m0, ins0), _ = lax.scan(
        row, (m, ins, dele, m0, ins0), jnp.arange(L, dtype=I32))
    total = jnp.where(col_ok, jnp.minimum(jnp.minimum(m, ins), dele), BIG)
    all_tot = jnp.concatenate([jnp.minimum(ins0, m0)[:, None], total], axis=1)
    end = jnp.argmin(all_tot, axis=1).astype(I32)
    cost = jnp.take_along_axis(all_tot, end[:, None], axis=1)[:, 0]
    return cost, end
