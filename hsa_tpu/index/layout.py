"""Fused rank-indexed occ/mark row layout for device gathers (v4).

This replaces the reference's interleaved occ-checkpoint BWT stream
(lineage: ``bwt.c:bwt_bwtupdate_core``, ``OCC_INTERVAL`` 0x80) with a
layout built for batched random row gathers: every FM primitive touches as
FEW rows as possible, rows are 32 bytes, and the decode is short.  The key
structural move is **rank-indexed fused rows**: one row per 32 SA *ranks* carrying
occ checkpoints, BWT symbols, locate mark bits and the mark-rank
checkpoint together, so that an LF step — and therefore every locate-walk
step — needs exactly ONE gather (v3 needed two: occ row + mark row).

Row b (uint32[8], 32 bytes) covers ranks [32b, 32b+32)::

    w0..w3  checkpoint: # of base a among STORED bwt symbols at ranks
            < 32b (the primary rank's slot is excluded)
    w4,w5   2-bit symbols of rank slots 32b+0..15 / 32b+16..31,
            little-end-first; the primary rank's slot holds 0 (dummy —
            in-block counts of base 0 past that slot are corrected with
            the statically-known primary position)
    w6      mark bits: bit j set iff rank 32b+j is marked
            (SA[r] % sa_intv == 0 — text-position sampling, fmcore.py)
    w7      # marked ranks < 32b

``samples`` holds the SA values of marked ranks in rank order.

nb = (n+1)//32 + 1 so a prefix length of exactly n+1 is addressable (the
final row may be a pure checkpoint).  1 byte/symbol total — human-genome
(3.1 Gbp) forward+reverse tables fit device memory with room for samples.

All ranks/positions/counts are uint32: the genome length bound is 2^32-2
(~4.3 Gbp), which covers the human genome without 64-bit device integers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BLOCK = 32           # ranks per fused row
OCC_ROW = 8          # uint32 words per row

LAYOUT_VERSION = 4


@dataclass
class DeviceIndex:
    """Host-side (numpy) container; ``as_jax()`` moves arrays to device."""

    n: int                   # text length
    primary: int             # rank of the sentinel row
    sa_intv: int
    C: np.ndarray            # uint32[5]
    occ_blocks: np.ndarray   # uint32[nb, 8] fused rows (see module doc)
    samples: np.ndarray      # uint32[n_marked]
    # reverse-text occ table (for the D-array width pass); may be None when
    # only exact search is needed
    rev_primary: int = -1
    rev_occ_blocks: np.ndarray | None = None
    # full suffix array (4B/base): locate becomes ONE gather instead of an
    # sa_intv-step LF walk.  Built when the memory budget allows
    # (build_device_index sa_direct flag); None for genome-scale indexes.
    sa_direct: np.ndarray | None = None

    def as_jax(self):
        import jax.numpy as jnp
        from types import SimpleNamespace
        return SimpleNamespace(
            n=np.uint32(self.n), primary=np.uint32(self.primary),
            sa_intv=int(self.sa_intv),
            C=jnp.asarray(self.C),
            occ_blocks=jnp.asarray(self.occ_blocks),
            samples=jnp.asarray(self.samples),
            rev_primary=np.uint32(self.rev_primary & 0xFFFFFFFF),
            rev_occ_blocks=(jnp.asarray(self.rev_occ_blocks)
                            if self.rev_occ_blocks is not None else None),
            sa_direct=(jnp.asarray(self.sa_direct)
                       if self.sa_direct is not None else None),
        )

    def save(self, path: str):
        empty = np.zeros((0, OCC_ROW), np.uint32)
        # compression is worthwhile only for small indexes: zlib inflate of a
        # multi-GB genome index takes tens of minutes single-threaded at load
        total = self.occ_blocks.nbytes * (2 if self.rev_occ_blocks is not None
                                          else 1)
        savez = np.savez_compressed if total < (256 << 20) else np.savez
        savez(
            path, n=self.n, primary=self.primary, sa_intv=self.sa_intv,
            layout_version=LAYOUT_VERSION,
            C=self.C, occ_blocks=self.occ_blocks,
            samples=self.samples, rev_primary=self.rev_primary,
            rev_occ_blocks=(self.rev_occ_blocks if self.rev_occ_blocks is not None
                            else empty),
            sa_direct=(self.sa_direct if self.sa_direct is not None
                       else np.zeros(0, np.uint32)))

    @classmethod
    def load(cls, path: str) -> "DeviceIndex":
        z = np.load(path)
        if int(z.get("layout_version", 1)) != LAYOUT_VERSION:
            raise ValueError(f"{path}: old index layout; rebuild with "
                             f"hsa-tpu index (layout_version {LAYOUT_VERSION} "
                             f"expected)")
        rev = z["rev_occ_blocks"]
        sad = z["sa_direct"] if "sa_direct" in z else np.zeros(0, np.uint32)
        return cls(n=int(z["n"]), primary=int(z["primary"]),
                   sa_intv=int(z["sa_intv"]), C=z["C"],
                   occ_blocks=z["occ_blocks"],
                   samples=z["samples"], rev_primary=int(z["rev_primary"]),
                   rev_occ_blocks=rev if rev.size else None,
                   sa_direct=sad if sad.size else None)


def _pack_rows(bwt: np.ndarray, primary: int, marks: np.ndarray | None,
               n: int) -> np.ndarray:
    """uint32[nb, 8] fused rank-indexed rows from a stored BWT (codes 0..3).

    ``marks``: uint8/bool[n+1] over ranks, or None (reverse index — mark
    words left zero).
    """
    n1 = n + 1                      # ranks 0..n
    nb = n1 // BLOCK + 1
    # rank-slot symbol array with a dummy 0 at the primary rank
    sym_rank = np.zeros(nb * BLOCK, dtype=np.uint32)
    sym_rank[:primary] = bwt[:primary]
    sym_rank[primary + 1:n1] = bwt[primary:]
    # stored-symbol indicator per rank slot (primary slot and padding = 0)
    stored = np.zeros(nb * BLOCK, dtype=bool)
    stored[:n1] = True
    stored[primary] = False

    rows = np.zeros((nb, OCC_ROW), dtype=np.uint32)
    sym_b = sym_rank.reshape(nb, BLOCK)
    stored_b = stored.reshape(nb, BLOCK)
    for a in range(4):
        per_block = ((sym_b == a) & stored_b).sum(axis=1, dtype=np.uint64)
        rows[:, a] = np.concatenate([[0], np.cumsum(per_block)[:-1]]).astype(np.uint32)
    w = sym_b.reshape(nb, 2, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    rows[:, 4:6] = (w << shifts).sum(axis=2, dtype=np.uint64).astype(np.uint32)
    if marks is not None:
        m = np.zeros(nb * BLOCK, dtype=np.uint32)
        m[:n1] = np.asarray(marks[:n1], dtype=np.uint32)
        bits = m.reshape(nb, BLOCK)
        sh = np.arange(BLOCK, dtype=np.uint32)[None, :]
        rows[:, 6] = (bits << sh).sum(axis=1, dtype=np.uint64).astype(np.uint32)
        per_block = bits.sum(axis=1, dtype=np.uint64)
        rows[:, 7] = np.concatenate([[0], np.cumsum(per_block)[:-1]]).astype(np.uint32)
    return rows


SA_DIRECT_MAX_N = 512_000_000   # 4B/base full-SA budget (2 GB)


def build_device_index(text: np.ndarray, sa_intv: int = 32,
                       with_reverse: bool = True,
                       sa_direct: bool | None = None) -> DeviceIndex:
    """Full index build: native SA-IS (refpack) -> fused device layout.

    ``text``: int8/uint8 codes 0..3 (ambiguity-substituted).
    ``sa_direct``: also keep the full suffix array (4B/base — locate
    becomes one gather); default: yes for genomes <= SA_DIRECT_MAX_N.
    """
    from .. import refpack

    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(t)
    if sa_direct is None:
        sa_direct = n <= SA_DIRECT_MAX_N
    sa, bwt, primary, marks, samples = refpack.build(t, sa_intv=sa_intv,
                                                     want_sa=sa_direct)
    counts = np.bincount(t, minlength=4).astype(np.uint64)
    C = np.concatenate([[1], 1 + np.cumsum(counts)]).astype(np.uint32)
    occ = _pack_rows(bwt, primary, marks, n)
    rev_primary, rev_occ = -1, None
    if with_reverse:
        _, rbwt, rev_primary, _, _ = refpack.build(t[::-1].copy(), sa_intv=sa_intv)
        rev_occ = _pack_rows(rbwt, rev_primary, None, n)
    return DeviceIndex(n=n, primary=primary, sa_intv=sa_intv, C=C,
                       occ_blocks=occ,
                       samples=samples.astype(np.uint32),
                       rev_primary=rev_primary, rev_occ_blocks=rev_occ,
                       sa_direct=(sa.astype(np.uint32) if sa_direct else None))
