"""Shared helpers for the five benchmark configs.

Each config script prints one JSON line (same shape as bench.py).  Genomes
are synthetic (made from a seed; nothing is downloaded); sizes are
overridable via HSA_BENCH_* env vars.  Indexes cache under
``.cache/bench`` in the checkout (``hsa_tpu.cache``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from hsa_tpu.cache import ROOT, enable_compile_cache  # noqa: E402

CACHE = os.path.join(ROOT, "bench")


def setup_jax(platform=None):
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    enable_compile_cache()
    return jax


def synth_genome(n: int, model: str = "iid", seed: int = 7) -> np.ndarray:
    """Synthetic genome made from ``seed``.

    ``iid``: uniform random bases (optimistic for beam width,
    pessimistic for cache reuse).
    ``repeats``: stresses multi-hit/overflow paths like real genomes do —
    55% i.i.d. background, 30% dispersed repeat-family copies (Alu-like:
    300bp consensus sequences re-inserted with 2-8% divergence), 10%
    segmental duplications (10-50 kbp blocks copied with 1% divergence),
    5% tandem repeats (2-6bp motifs, 50-500 copies).
    """
    rs = np.random.RandomState(seed)
    if model == "iid":
        return rs.randint(0, 4, n).astype(np.int8)
    g = rs.randint(0, 4, n).astype(np.int8)

    def mutate(seg, rate):
        m = rs.rand(len(seg)) < rate
        seg = seg.copy()
        seg[m] = (seg[m] + rs.randint(1, 4, int(m.sum()))) % 4
        return seg

    # dispersed repeat families (the Alu-like bulk)
    fam_bp = int(n * 0.30)
    families = [rs.randint(0, 4, 300).astype(np.int8) for _ in range(8)]
    placed = 0
    while placed < fam_bp:
        fam = families[rs.randint(len(families))]
        p = rs.randint(0, n - 300)
        g[p:p + 300] = mutate(fam, rs.uniform(0.02, 0.08))
        placed += 300
    # segmental duplications
    dup_bp = int(n * 0.10)
    placed = 0
    while placed < dup_bp:
        ln = int(rs.randint(10_000, 50_000))
        if 2 * ln + 2 >= n:
            ln = max(n // 4, 1)
        src = rs.randint(0, n - ln)
        dst = rs.randint(0, n - ln)
        g[dst:dst + ln] = mutate(g[src:src + ln], 0.01)
        placed += ln
    # tandem repeats
    tr_bp = int(n * 0.05)
    placed = 0
    while placed < tr_bp:
        motif = rs.randint(0, 4, int(rs.randint(2, 7))).astype(np.int8)
        copies = int(rs.randint(50, 500))
        arr = np.tile(motif, copies)[:min(len(motif) * copies, n // 10)]
        p = rs.randint(0, n - len(arr))
        g[p:p + len(arr)] = arr
        placed += len(arr)
    return g


def cached_index(name: str, n: int, seed: int = 7, sa_intv: int = 32,
                 with_reverse: bool = True, model: str = "iid"):
    from hsa_tpu.index.layout import DeviceIndex, build_device_index
    os.makedirs(CACHE, exist_ok=True)
    tag = "" if model == "iid" else f"_{model}"
    ip = os.path.join(CACHE, f"{name}{tag}.npz")
    tp = os.path.join(CACHE, f"{name}{tag}_txt.npy")
    if os.path.exists(ip) and os.path.exists(tp):
        try:
            return DeviceIndex.load(ip), np.load(tp, mmap_mode="r")
        except ValueError:
            pass  # stale layout: rebuild
    t = synth_genome(n, model, seed=seed)
    di = build_device_index(t, sa_intv=sa_intv, with_reverse=with_reverse)
    di.save(ip)
    np.save(tp, t)
    return di, t


def sample_reads(text, n_reads, read_len, n_mm=0, indel=False, seed=1):
    rs = np.random.RandomState(seed)
    n = len(text)
    fwd = np.empty((n_reads, read_len), np.uint8)
    for j in range(n_reads):
        p = rs.randint(0, n - read_len - 2)
        r = np.asarray(text[p:p + read_len + (1 if indel and j % 4 == 0 else 0)]).copy()
        if indel and j % 4 == 0:
            cut = rs.randint(8, read_len - 8)
            r = np.concatenate([r[:cut], r[cut + 1:]])
        for _ in range(n_mm):
            q = rs.randint(0, read_len)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        fwd[j] = r[:read_len]
    return fwd


def timeit(fn, *args, iters=4):
    """Mean seconds per call after one warm-up call; each call ends in
    ``jax.block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return (time.time() - t0) / iters, out


def stream_campaigns(al, reads, batch, iters=6, reps=3):
    """Median of ``reps`` align_stream campaign means, with ONE untimed
    settle campaign first so steady-state shape classes (upshifted
    profile, retry/beam pads) compile outside the timed loop, as in the
    headline bench."""
    def batches():
        for it in range(iters):
            yield it * batch, None, reads, None
    for _s, _o in al.align_stream(batches(), emit="sam"):
        pass
    means = []
    for _rep in range(reps):
        ts = [time.time()]
        for _s, (lines, flags) in al.align_stream(batches(), emit="sam"):
            assert lines
            ts.append(time.time())
        means.append(float(np.diff(ts).mean()))
    return float(np.median(means)), means


def report(metric, value, unit, vs_baseline=None, **extra):
    rec = {"metric": metric, "value": round(float(value), 2), "unit": unit,
           "vs_baseline": round(float(vs_baseline), 3) if vs_baseline else None}
    rec.update(extra)
    print(json.dumps(rec))
