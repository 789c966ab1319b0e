"""Batched beam-search inexact alignment — the data-parallel replacement
for the reference's branch-and-bound stack (lineage: ``bwtgap.c`` ``gap_push`` /
``gap_pop`` / ``bwt_match_gap``; BASELINE.json north star).

Thousands of reads advance SA-interval *frontiers* in lockstep.  Each read
owns ``W`` frontier slots (states); one step expands every live state into
up to 9 children — 4 match/mismatch (one per base), 1 insertion, 4
deletions — scores them with the Appendix-A budgets, and keeps the best
``W`` by score.  Completed states (i == 0) migrate into a per-read hit
buffer of capacity ``H``.

Structure:

- The whole search is ONE ``lax.scan``; index tables arrive as jit
  arguments (never closures, which would embed them as constants).
- Cross-row work (top-W selection, hit-buffer merge, drop counting)
  goes through :func:`hsa_tpu.kernels.select.select_topk`.
- States are transposed **[W, B]** (slots on rows, reads on columns);
  the candidate matrices are [9W, B].  Per-read constants are
  pre-broadcast to flat [B*W] outside the scan.

Parity contract (SURVEY.md §7.3.1): the oracle's accepted hit set is
order-independent, so this engine reproduces it exactly *provided no valid
candidate is dropped* by the top-W selection or the hit buffer.  Both drop
events are counted and returned (``n_live_dropped`` / ``n_hits_dropped``);
a nonzero count on a read is a parity alarm for that read.  (The hit-drop
counter may overcount when more than H hits exist of which some fall
outside the final score window — a conservative, escalation-safe bias.)

Field limits implied by the meta packing: read length <= 511, nmm <= 15,
ngapo <= 7, ngape <= 15, seed diffs <= 15 (asserted); beam widths up to
W=1820 (9W < 2^14 key columns).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..kernels.select import select_topk, KEY_SH, SENT

U32 = jnp.uint32
I32 = jnp.int32
INF = jnp.int32(1 << 29)
_SCORE_NOHIT = 0x10000  # score field values at/above this mean "no hit"
M_, I_, D_ = 0, 1, 2

# meta bit layout
_I_BITS = 9
_NMM_SH, _GAPO_SH, _GAPE_SH, _SEED_SH, _ST_SH = 9, 13, 16, 20, 24


def _pack(i, nmm, ngapo, ngape, seed_mm, st):
    return (i.astype(U32) | (nmm.astype(U32) << _NMM_SH)
            | (ngapo.astype(U32) << _GAPO_SH) | (ngape.astype(U32) << _GAPE_SH)
            | (seed_mm.astype(U32) << _SEED_SH) | (st.astype(U32) << _ST_SH))


def _unpack(meta):
    i = (meta & U32(0x1FF)).astype(I32)
    nmm = ((meta >> _NMM_SH) & U32(0xF)).astype(I32)
    ngapo = ((meta >> _GAPO_SH) & U32(0x7)).astype(I32)
    ngape = ((meta >> _GAPE_SH) & U32(0xF)).astype(I32)
    seed_mm = ((meta >> _SEED_SH) & U32(0xF)).astype(I32)
    st = ((meta >> _ST_SH) & U32(0x3)).astype(I32)
    return i, nmm, ngapo, ngape, seed_mm, st


class RawBeamResult(NamedTuple):
    """Device-side search output, kept in the scan's layout ([H, B], reads
    on columns).  Finalization (score-window filter, meta unpack,
    transposition to read-major) happens on HOST at readback
    (``finalize_result``)."""
    hkey: jnp.ndarray        # uint32[H, B]  score << KEY_SH | row
    hit_k: jnp.ndarray       # uint32[H, B]
    hit_l: jnp.ndarray       # uint32[H, B]
    hit_meta: jnp.ndarray    # uint32[H, B]  packed (nmm/ngapo/ngape/...)
    best_raw: jnp.ndarray    # uint32[B]     best score (>= 0x10000: none)
    n_live_dropped: jnp.ndarray  # uint32[B] max per-step beam overflow
    n_hits_dropped: jnp.ndarray  # uint32[B]


class BeamResult(NamedTuple):
    """Host-side (numpy) finalized result, read-major."""
    hit_score: object        # int32[B, H]
    hit_k: object            # uint32[B, H]
    hit_l: object            # uint32[B, H]
    hit_nmm: object          # int32[B, H]
    hit_ngapo: object        # int32[B, H]
    hit_ngape: object        # int32[B, H]
    hit_valid: object        # bool[B, H]
    best_score: object       # int32[B] (INF when no hit)
    n_live_dropped: object   # int32[B] beam-overflow parity alarms
    n_hits_dropped: object   # int32[B]


def finalize_result(raw: RawBeamResult, s_mm: int) -> BeamResult:
    """Host finalization (READS BACK): window filter + unpack + transpose."""
    import numpy as np
    hkey = np.asarray(raw.hkey)
    hk = np.asarray(raw.hit_k)
    hl = np.asarray(raw.hit_l)
    hm = np.asarray(raw.hit_meta)
    best = np.asarray(raw.best_raw).astype(np.int64)
    ld = np.asarray(raw.n_live_dropped)
    hd = np.asarray(raw.n_hits_dropped)
    hscore = (hkey >> KEY_SH).astype(np.int64)
    hvalid = (hscore < _SCORE_NOHIT) & (hscore <= best[None, :] + s_mm)
    nmm = ((hm >> _NMM_SH) & 0xF).astype(np.int32)
    ngapo = ((hm >> _GAPO_SH) & 0x7).astype(np.int32)
    ngape = ((hm >> _GAPE_SH) & 0xF).astype(np.int32)
    best_i = np.where(best >= _SCORE_NOHIT, int(INF), best).astype(np.int32)
    score_i = np.where(hvalid, hscore, int(INF)).astype(np.int32)
    return BeamResult(hit_score=score_i.T, hit_k=hk.T, hit_l=hl.T,
                      hit_nmm=nmm.T, hit_ngapo=ngapo.T, hit_ngape=ngape.T,
                      hit_valid=hvalid.T, best_score=best_i,
                      n_live_dropped=ld.astype(np.int32),
                      n_hits_dropped=hd.astype(np.int32))


def beam_search(idx, reads_fwd, lens, D, max_diff, opt, *,
                beam_width: int | None = None, max_hits: int = 32) -> RawBeamResult:
    """Run the inexact search for a whole batch.

    reads_fwd: int32/uint8 [B, Lmax] codes in 5'->3' order (PAD beyond len)
    lens:      int32[B]
    D:         int32[B, Lmax] width lower bounds (from cal_width_device);
               pass zeros to disable pruning (hit set unchanged)
    max_diff:  int32[B] per-read diff budgets
    """
    from . import fm

    W = beam_width or opt.beam_width
    H = max_hits
    B, Lmax = reads_fwd.shape
    BW = B * W
    assert Lmax < (1 << _I_BITS), "read length exceeds packed-state limit (511)"
    assert opt.max_gapo <= 7 and opt.max_gape <= 15 and opt.max_seed_diff <= 15
    assert 9 * W < (1 << KEY_SH), "beam width exceeds selection-key column field"
    reads_fwd = reads_fwd.astype(I32)
    lens = lens.astype(I32)
    # budgets above 15 cannot be represented in the 4-bit nmm packing; the
    # numpy entry (align_batch) asserts, this clamp is the traced-path belt
    max_diff = jnp.minimum(max_diff.astype(I32), 15)
    s_mm, s_gapo, s_gape = opt.s_mm, opt.s_gapo, opt.s_gape
    skip = opt.indel_end_skip

    # Dshift[b, j] = D[b, j-1], Dshift[b, 0] = 0  (lower bound for prefix len j).
    # The per-state step needs read[i-1], Dshift[i-1], Dshift[i]; pack all
    # three into one word indexed by j = i-1 so the step does ONE gather:
    #   combo[j] = read[j] | min(Dshift[j],31)<<3 | min(Dshift[j+1],31)<<8
    # (D clamps at 31: budgets are <= 15, so the pruning test is unchanged)
    Dshift = jnp.concatenate([jnp.zeros((B, 1), I32), D.astype(I32)], axis=1)
    Dc = jnp.minimum(Dshift, 31)
    combo = (reads_fwd | (Dc[:, :Lmax] << 3) | (Dc[:, 1:Lmax + 1] << 8)).reshape(-1)
    combo = lax.optimization_barrier(combo)

    def bc(x):  # per-read value -> flat [W*B], w-major (column = read)
        return jnp.broadcast_to(x[None, :], (W, B)).reshape(-1)

    # loop-invariant flat broadcasts / constants (computed OUTSIDE the scan)
    mdF = bc(max_diff)
    lensF = bc(lens)
    seedF = bc(lens - opt.seed_len)      # in_seed iff i > seed_start
    rowL = bc(jnp.arange(B, dtype=I32) * Lmax)

    with_gaps = opt.max_gapo > 0
    G = 9 if with_gaps else 4            # candidate groups
    HG = 5 if with_gaps else 4           # read-consuming groups (can complete)
    C = G * W
    HC = HG * W
    colC = jnp.broadcast_to(jnp.arange(C, dtype=U32)[:, None], (C, B))
    colM = jnp.broadcast_to(jnp.arange(H + HC, dtype=U32)[:, None], (H + HC, B))
    rowH = jnp.broadcast_to(jnp.arange(H, dtype=U32)[:, None], (H, B))

    # frontier init: slot 0 (row 0) holds [0, n], i = len
    first = jnp.broadcast_to((jnp.arange(W, dtype=I32) == 0)[:, None],
                             (W, B)).reshape(-1)
    k0 = jnp.zeros(BW, U32)
    l0 = jnp.where(first, jnp.uint32(idx.n), U32(0))
    meta0 = jnp.where(first & (lensF > 0), lensF.astype(U32), U32(0))
    score0 = jnp.zeros(BW, I32)
    live0 = first & (lensF > 0)

    hkey0 = jnp.full((H, B), SENT, U32) | rowH   # invalid, unique columns
    hk0 = jnp.zeros((H, B), U32)
    hl0 = jnp.zeros((H, B), U32)
    hm0 = jnp.zeros((H, B), U32)
    best0 = jnp.full(B, jnp.uint32(_SCORE_NOHIT), U32)
    drops0 = jnp.zeros(B, U32)

    n_steps = Lmax + (opt.max_gapo + opt.max_gape if with_gaps else 0)

    def step(carry, _):
        (k, l, meta, score, live,
         hkey, hk, hl, hm, best, ldrop, hdrop) = carry

        i, nmm, ngapo, ngape, seed_mm, st = _unpack(meta)
        ndiff = nmm + ngapo + ngape
        expand = live & (i > 0)
        gidx = rowL + jnp.clip(i - 1, 0, Lmax - 1)
        cw = lax.optimization_barrier(jnp.take(combo, gidx))   # [W*B]
        b = cw & 7
        lb_im1 = (cw >> 3) & 31   # Dshift[i-1]: bound for the i-1 children
        in_seed = (i > seedF).astype(I32)

        # one fused occ pass for all 4 bases at both interval ends (flat)
        k4, l4 = fm.extend4_flat(idx, k, l)

        groups = []  # (valid, k, l, meta, score) flats, w-major

        for a in range(4):  # match/mismatch children (consume a read base)
            ismm = (b != a).astype(I32)
            seed_add = ismm * in_seed
            child_meta = _pack(i - 1, nmm + ismm, ngapo, ngape,
                               seed_mm + seed_add, jnp.zeros_like(i))
            child_ndiff = ndiff + ismm
            ok = (expand & (k4[a] <= l4[a])
                  & (child_ndiff + lb_im1 <= mdF)
                  & (seed_mm + seed_add <= opt.max_seed_diff))
            groups.append((ok, k4[a], l4[a], child_meta, score + ismm * s_mm))

        if with_gaps:
            consumed = lensF - i
            indel_ok = (consumed >= skip) & (i >= skip)
            lb_i = (cw >> 8) & 31  # Dshift[i]: bound for deletion children
            open_ = st == M_
            gap_cost = jnp.where(open_, s_gapo, s_gape)
            d_gapo, d_gape = open_.astype(I32), (~open_).astype(I32)
            ins_ok = indel_ok & ((open_ & (ngapo < opt.max_gapo))
                                 | ((st == I_) & (ngape < opt.max_gape)))
            del_ok = indel_ok & ((open_ & (ngapo < opt.max_gapo))
                                 | ((st == D_) & (ngape < opt.max_gape)))

            # insertion child (consume a read base, interval unchanged)
            child_meta = _pack(i - 1, nmm, ngapo + d_gapo, ngape + d_gape,
                               seed_mm + in_seed, jnp.full_like(i, I_))
            ok = (expand & ins_ok
                  & (ndiff + 1 + lb_im1 <= mdF)
                  & (seed_mm + in_seed <= opt.max_seed_diff))
            groups.append((ok, k, l, child_meta, score + gap_cost))

            # 4 deletion children (consume a genome base, i unchanged)
            for a in range(4):
                child_meta = _pack(i, nmm, ngapo + d_gapo, ngape + d_gape,
                                   seed_mm + in_seed, jnp.full_like(i, D_))
                ok = (expand & del_ok & (k4[a] <= l4[a])
                      & (ndiff + 1 + lb_i <= mdF)
                      & (seed_mm + in_seed <= opt.max_seed_diff))
                groups.append((ok, k4[a], l4[a], child_meta, score + gap_cost))

        # per-group live/hit validity + keys, all flat; then [rows, B] mats
        child_i = [(g[3] & U32(0x1FF)).astype(I32) for g in groups]
        skey = [g[4].astype(U32) << KEY_SH for g in groups]

        def matT(xs):
            return jnp.concatenate([x.reshape(W, B) for x in xs], axis=0)

        live_key = matT([jnp.where(g[0] & (ci > 0), sk, SENT)
                         for g, ci, sk in zip(groups, child_i, skey)]) | colC
        kc = matT([g[1] for g in groups])
        lc = matT([g[2] for g in groups])
        mc = matT([g[3] for g in groups])

        hitg = groups[:HG]
        hit_key = matT([jnp.where(g[0] & (ci == 0), sk, SENT)
                        for g, ci, sk in zip(hitg, child_i[:HG], skey[:HG])])

        # --- hit merge: old buffer + completion candidates ---
        mkey = jnp.concatenate([hkey, hit_key | colM[H:]], axis=0)
        mk = jnp.concatenate([hk, kc[:HC]], axis=0)
        ml = jnp.concatenate([hl, lc[:HC]], axis=0)
        mm_ = jnp.concatenate([hm, mc[:HC]], axis=0)
        # Drop tracking: running MAX of per-step drop counts.  >0 iff any
        # step overflowed, which is the parity-alarm semantics every
        # consumer relies on.
        okeyd, (hk2, hl2, hm2), _ = select_topk(mkey, (mk, ml, mm_), H)
        okey = okeyd[:H]
        hdrop_i = okeyd[H]
        hdrop = jnp.where(hdrop_i > hdrop, hdrop_i, hdrop)
        cand_best = okey[0] >> KEY_SH                   # row 0 = best hit
        best2 = jnp.where(cand_best < best, cand_best, best)
        # re-key buffer rows so columns stay unique next step
        hkey2 = ((okey >> KEY_SH) << KEY_SH) | rowH

        # --- frontier selection, windowed at best + s_mm ---
        win = best2 + U32(s_mm)
        lkeyd, (k2, l2, m2), _ = select_topk(
            live_key, (kc, lc, mc), W, window=win)
        lkey = lkeyd[:W]
        ldrop_i = lkeyd[W]
        ldrop = jnp.where(ldrop_i > ldrop, ldrop_i, ldrop)
        live2 = (lkey < SENT).reshape(-1)
        score2 = jnp.where(lkey < SENT, lkey >> KEY_SH, U32(0)).reshape(-1).astype(I32)

        return ((k2.reshape(-1), l2.reshape(-1), m2.reshape(-1),
                 score2, live2,
                 hkey2, hk2, hl2, hm2, best2, ldrop, hdrop), None)

    carry0 = (k0, l0, meta0, score0, live0,
              hkey0, hk0, hl0, hm0, best0, drops0, drops0)
    (k, l, meta, score, live,
     hkey, hk, hl, hm, best, ldrop, hdrop), _ = lax.scan(
        step, carry0, None, length=n_steps)

    # NO device post-processing: finalization (window filter, unpack,
    # transposition) runs on host at readback — see finalize_result
    return RawBeamResult(hkey=hkey, hit_k=hk, hit_l=hl, hit_meta=hm,
                         best_raw=best, n_live_dropped=ldrop,
                         n_hits_dropped=hdrop)


_jit_cache = {}


def _opt_key(opt):
    return tuple(sorted(opt.to_dict().items()))


def _jitted(idx, kind, body):
    """Per-index cache of jitted device functions (eager tracing of the
    scan-based passes costs more than the device work itself).  Keys include
    every value baked into the closure (index identity, kind, opt).  Index
    tables are passed as jit ARGUMENTS, not closures — closure arrays become
    HLO literals, which bloats the program on multi-GB indexes."""
    from .jitcache import jit_over_idx
    key = (id(idx), kind)
    f = _jit_cache.get(key)
    if f is None:
        f = jit_over_idx(idx, body)
        _jit_cache[key] = f
    return f


def pack_read_batch(reads, max_len=None):
    """Host-side packing: list of code arrays -> (fwd uint8[B,Lmax], lens)."""
    import numpy as np
    Lmax = max_len or max(len(r) for r in reads)
    B = len(reads)
    too_long = max(len(r) for r in reads)
    if too_long > Lmax:
        raise ValueError(f"read length {too_long} exceeds max_len {Lmax}; "
                         f"truncating silently would misreport alignments")
    fwd = np.full((B, Lmax), 5, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, r in enumerate(reads):
        L = len(r)
        fwd[j, :L] = np.asarray(r, dtype=np.uint8)
        lens[j] = L
    return fwd, lens


def search_device(idx, fwd, lens, opt, *, beam_width=None, max_hits=32,
                  ladder=None):
    """Device-only search: packed batch -> BeamResult (device arrays).

    Performs NO device->host transfer — the caller decides when to read
    results back (the split lets callers overlap several searches per
    readback).
    ``fwd``/``lens`` are numpy or device arrays.
    """
    import numpy as np
    from .widths import cal_width_device

    B, Lmax = fwd.shape
    md = np.array([opt.diff_budget(int(L)) for L in np.asarray(lens)],
                  dtype=np.int32)
    if md.size and md.max() > 15:
        raise ValueError("diff budget > 15 unsupported by the packed beam "
                         "state (and unrealistic for short-read budgets)")
    fwd_j = jnp.asarray(fwd)
    lens_j = jnp.asarray(lens)
    if idx.rev_occ_blocks is not None:
        width_f = _jitted(idx, "width",
                          lambda ix, r, l: cal_width_device(ix, r, l))
        D = width_f(fwd_j, lens_j)
    else:
        D = jnp.zeros((B, Lmax), I32)
    if ladder:
        from .adaptive import AdaptiveBeam
        key = (id(idx), "ladder", tuple(ladder), max_hits, _opt_key(opt))
        ab = _jit_cache.get(key)
        if ab is None:
            ab = AdaptiveBeam(idx, opt, ladder=ladder, max_hits=max_hits)
            _jit_cache[key] = ab
        return ab(fwd_j, lens_j, D, jnp.asarray(md))
    W, H = beam_width, max_hits
    beam_f = _jitted(idx, ("beam", W or opt.beam_width, H, _opt_key(opt)),
                     lambda ix, rf, ln, D_, m_: beam_search(
                         ix, rf, ln, D_, m_, opt, beam_width=W, max_hits=H))
    return beam_f(fwd_j, lens_j, D, jnp.asarray(md))


def result_to_hits(res, s_mm: int = 3):
    """Host conversion (reads back!): result -> per-read sorted hit lists.

    ``s_mm`` is only used when ``res`` is still a raw device result (it
    parameterizes the final score-window filter).
    """
    import numpy as np
    from ..oracle.bnb import Hit
    if not isinstance(res, BeamResult):
        from .adaptive import finalize_any
        res = finalize_any(res, s_mm)
    out = []
    hv = np.asarray(res.hit_valid)
    hs = np.asarray(res.hit_score)
    hk = np.asarray(res.hit_k)
    hl = np.asarray(res.hit_l)
    hm = np.asarray(res.hit_nmm)
    ho = np.asarray(res.hit_ngapo)
    he = np.asarray(res.hit_ngape)
    for j in range(hv.shape[0]):
        seen = {}
        for h in range(hv.shape[1]):
            if not hv[j, h]:
                continue
            key = (int(hk[j, h]), int(hl[j, h]), int(hm[j, h]), int(ho[j, h]), int(he[j, h]))
            sc = int(hs[j, h])
            if key not in seen or seen[key] > sc:
                seen[key] = sc
        hits = [Hit(sc, nmm, ngapo, ngape, k_, l_)
                for (k_, l_, nmm, ngapo, ngape), sc in seen.items()]
        hits.sort(key=lambda h: (h.score, h.k, h.l, h.nmm, h.ngapo, h.ngape))
        out.append(hits)
    return out


def align_batch(idx, reads, opt, *, beam_width=None, max_hits=32, max_len=None,
                ladder=None):
    """Host convenience wrapper: list of code arrays -> per-read hit lists.

    Returns (hits_per_read, result).  Reads results back immediately — use
    :func:`search_device` + :func:`result_to_hits` for the two-phase flow.
    """
    fwd, lens = pack_read_batch(reads, max_len)
    raw = search_device(idx, fwd, lens, opt, beam_width=beam_width,
                        max_hits=max_hits, ladder=ladder)
    from .adaptive import finalize_any
    res = finalize_any(raw, opt.s_mm)
    return result_to_hits(res), res
