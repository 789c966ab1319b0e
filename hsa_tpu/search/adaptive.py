"""Adaptive beam escalation: narrow beams first, escalate flagged reads.

The overflow counters make beam truncation *observable* per read, which
turns beam width into a ladder instead of a global knob: run everything at
a cheap width, then re-run only the reads whose beam or hit buffer
overflowed at the next width.  A read that never overflows has the exact
(oracle-equal) hit set regardless of the width that produced it, so a
ladder's output quality equals running every read at the highest width it
reached.

The whole ladder is ONE jitted device function: flagged reads are selected
with a static-size ``jnp.nonzero`` (capacity = ``esc_frac`` of the batch per
rung), re-searched at the next width — no host round-trips.  Reads flagged
beyond a rung's capacity keep their current results and stay flagged, so
truncation remains observable.  The escalated sub-batch is padded to the
full capacity, so ``esc_frac`` trades rung cost against the flagged-read
fraction it can absorb (typical k=2 overflow is ~10%; the default 1/8
capacity covers it with ~25% headroom).

Device/host split: the device function returns the RAW per-rung results
plus the escalation index maps; merging the [H, B] hit buffers happens on
HOST at readback (``finalize_ladder``).  Flat [B] flag scatters keep
multi-rung flag propagation on device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .beam import RawBeamResult, BeamResult, beam_search, finalize_result
from .jitcache import join_idx, split_idx


class LadderRawResult(NamedTuple):
    raws: tuple            # per-rung RawBeamResult (rung 0 = full batch)
    esc_idx: tuple         # per-escalation int32[ESC] read ids (fill = B)
    esc_valid: tuple       # per-escalation bool[ESC]


def ladder_core(dev, fwd, lens, D, md, opt, ladder, H: int, ESC: int,
                B: int) -> LadderRawResult:
    """Traceable ladder body (composable into larger jits).

    ``ESC`` = escalation sub-batch capacity; ``B`` = batch size (used as
    the out-of-range nonzero fill).
    """
    raw = beam_search(dev, fwd, lens, D, md, opt,
                      beam_width=ladder[0], max_hits=H)
    raws = [raw]
    esc_idx, esc_valid = [], []
    # flat [B] flag state, updated by flat scatters
    ldrop = raw.n_live_dropped
    hdrop = raw.n_hits_dropped
    for W in ladder[1:]:
        flag = (ldrop > 0) | (hdrop > 0)
        n_flag = flag.sum()
        # fill with an OUT-OF-RANGE index: gathers clamp (harmless,
        # masked by `valid`) and flag-scatter DROPS those rows
        idx = jnp.nonzero(flag, size=ESC, fill_value=B)[0]
        valid = jnp.arange(ESC) < n_flag
        sub = beam_search(
            dev, fwd[idx], jnp.where(valid, lens[idx], 0),
            D[idx], md[idx], opt, beam_width=W, max_hits=H)
        raws.append(sub)
        esc_idx.append(idx)
        esc_valid.append(valid)
        ldrop = ldrop.at[idx].set(
            jnp.where(valid, sub.n_live_dropped, ldrop[idx]))
        hdrop = hdrop.at[idx].set(
            jnp.where(valid, sub.n_hits_dropped, hdrop[idx]))
    return LadderRawResult(tuple(raws), tuple(esc_idx), tuple(esc_valid))


class AdaptiveBeam:
    """Caches one jitted ladder function per batch size."""

    def __init__(self, dev_idx, opt, *, ladder=(8, 64), max_hits: int = 16,
                 esc_frac: float = 1 / 8, esc_batch=None):
        self.dev = dev_idx
        self.opt = opt
        self.ladder = tuple(ladder)
        self.max_hits = max_hits
        self.esc_frac = esc_frac
        self._arrays = split_idx(dev_idx)[0]
        self._jit_cache = {}

    def _ladder_fn(self, B: int):
        """The jitted ladder for batch size B: fn(index arrays, fwd, lens,
        D, md)."""
        if B in self._jit_cache:
            return self._jit_cache[B]
        opt, H = self.opt, self.max_hits
        ladder = self.ladder
        ESC = max(int(B * self.esc_frac), 1)
        _, meta = split_idx(self.dev)

        @jax.jit
        def run_core(arrs, fwd, lens, D, md):
            dev = join_idx(meta, arrs)
            res = ladder_core(dev, fwd, lens, D, md, opt, ladder, H, ESC, B)
            return tuple(res.raws), tuple(res.esc_idx), tuple(res.esc_valid)

        self._jit_cache[B] = run_core
        return run_core

    def __call__(self, fwd, lens, D, md) -> LadderRawResult:
        fwd = jnp.asarray(fwd)
        return LadderRawResult(*self._ladder_fn(fwd.shape[0])(
            self._arrays, fwd, jnp.asarray(lens), jnp.asarray(D),
            jnp.asarray(md)))

    def lower(self, fwd, lens, D, md):
        """``jax.stages.Lowered`` of the ladder for these arguments
        (arrays or ShapeDtypeStructs) — for memory analysis."""
        return self._ladder_fn(fwd.shape[0]).lower(self._arrays, fwd, lens,
                                                   D, md)


def primary_ranks(res, n) -> jnp.ndarray:
    """Device-side [B] ranks of each read's first hit-buffer slot (rank 0
    when the slot is invalid) — for benchmark-style primary locates."""
    from ..kernels.select import SENT

    def one(raw):
        v = raw.hkey[0] < SENT
        return jnp.where(v, raw.hit_k[0], jnp.uint32(0)), v

    if isinstance(res, RawBeamResult):
        return one(res)[0]
    ranks, _ = one(res.raws[0])
    for raw, idx, valid in zip(res.raws[1:], res.esc_idx, res.esc_valid):
        r2, _ = one(raw)
        ranks = ranks.at[idx].set(jnp.where(valid, r2, ranks[idx]))
    return ranks


def finalize_ladder(res: LadderRawResult, s_mm: int) -> BeamResult:
    """Host merge (READS BACK): per-rung finalize + numpy scatter merge."""
    out = finalize_result(res.raws[0], s_mm)
    fields = list(out)
    for raw, idx, valid in zip(res.raws[1:], res.esc_idx, res.esc_valid):
        sub = finalize_result(raw, s_mm)
        idx = np.asarray(idx)
        valid = np.asarray(valid)
        sel = idx[valid]
        subsel = np.nonzero(valid)[0]
        for fi in range(len(fields)):
            f = np.array(fields[fi])
            f[sel] = np.asarray(sub[fi])[subsel]
            fields[fi] = f
    return BeamResult(*fields)


def finalize_any(res, s_mm: int) -> BeamResult:
    if isinstance(res, LadderRawResult):
        return finalize_ladder(res, s_mm)
    if isinstance(res, RawBeamResult):
        return finalize_result(res, s_mm)
    return res
