"""Diagnose the repeats-genome fallback population (round 4).

Which reads still re-run on the beam, and why: structural flag vs
truncated-with-no-verified-candidate; and what the beam finds for them
(nmm/gap profile) — i.e. what the pigeon screen is missing.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from common import CACHE, setup_jax  # noqa: E402

B = int(os.environ.get("HSA_BENCH_BATCH", "16384"))
L = 100


def main():
    setup_jax()
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner, ReadBatch
    from hsa_tpu.search import pigeon as pg

    from hsa_tpu.index.layout import DeviceIndex
    cache = CACHE
    di = DeviceIndex.load(os.path.join(cache, "idx_64M_repeats_v4b_s8.npz"))
    text = np.asarray(np.load(os.path.join(cache, "txt_64M_repeats.npy"),
                              mmap_mode="r"), np.int8)
    opt = AlnOpt(max_diff=2)
    kdir = os.path.join(cache, "idxdir_64M_repeats_s8")
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                             engine="auto", index_dir=kdir)
    # bench-style reads: k=2 planted mismatches, half reverse strand
    rs = np.random.RandomState(1)
    n_genome = len(text)
    mat = np.empty((B, L), np.uint8)
    for j in range(B):
        p = rs.randint(0, n_genome - L)
        r = np.asarray(text[p:p + L]).copy()
        for _ in range(2):
            q = rs.randint(0, L)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        if j % 2:
            r = (3 - r)[::-1].copy()
        mat[j] = r
    fwd = mat
    reads = ReadBatch(fwd, np.full(B, L, np.int32))
    n_seg, elig = al._pigeon_split(reads)
    print("n_seg", n_seg, "elig", len(elig), flush=True)
    res = al._pigeon_raw(reads, n_seg)
    occ, fb, missed = pg.pigeon_occ_arrays(res, B, opt, al._PIGEON_CAND_CAP)
    has_occ = np.zeros(B, bool)
    if occ["rid"].size:
        has_occ[np.unique(occ["rid"])] = True
    struct_fb = fb.copy()
    trunc_noocc = (missed > 0) & ~has_occ & ~fb
    print(f"structural fallback: {struct_fb.sum()} ({struct_fb.mean():.4f})")
    print(f"trunc-no-verify fallback: {trunc_noocc.sum()} "
          f"({trunc_noocc.mean():.4f})")
    print(f"trunc kept: {((missed > 0) & has_occ).sum()}")
    print(f"missed>0 total: {(missed > 0).sum()}; "
          f"median missed of trunc: "
          f"{np.median(missed[missed > 0]) if (missed > 0).any() else 0}")
    # e2e stage attribution (device / beam-fallback / resolve)
    from hsa_tpu.resolve.samse import resolve_from_occ_arrays
    h = al._align_device(reads)
    t0 = time.time()
    h = al._align_device(reads)
    t_dev = time.time() - t0
    t0 = time.time()
    occ2, trunc2, c2x = al._align_occ(h)
    t_occ = time.time() - t0
    names = [f"r{i}" for i in range(B)]
    t0 = time.time()
    resolve_from_occ_arrays(text, al.meta, reads, names, None, occ2,
                            trunc2, opt, emit="sam", c2_extra=c2x)
    t_res = time.time() - t0
    print(f"stage ms: device={t_dev*1e3:.0f} occ(+beam-fb)={t_occ*1e3:.0f} "
          f"resolve={t_res*1e3:.0f}; occ entries={len(occ2['rid'])}",
          flush=True)

    # what does the beam find for the fallback reads?
    fb_all = np.flatnonzero(struct_fb | trunc_noocc)[:512]
    if len(fb_all):
        from hsa_tpu.resolve.samse import collect_occurrences
        bsub = [np.asarray(fwd[j], np.int8) for j in fb_all]
        tgt = 1 << max(len(bsub) - 1, 0).bit_length()
        bsub += [bsub[0]] * (tgt - len(bsub))
        hf, hr = al.search_batch(bsub, ladder=al.ladder)
        occs, tr = collect_occurrences(hf, hr, al.locate_fn)
        occs = occs[:len(fb_all)]
        n_map = sum(1 for o in occs if o)
        prof = {}
        nocc_sizes = []
        for o in occs:
            if not o:
                prof["unmapped"] = prof.get("unmapped", 0) + 1
                continue
            b = min(o, key=lambda x: x.score)
            key = (b.nmm, b.ngapo + b.ngape)
            prof[key] = prof.get(key, 0) + 1
            nocc_sizes.append(len(o))
        print(f"beam mapped {n_map}/{len(fb_all)}; best (nmm,ngap) profile: "
              f"{dict(sorted(prof.items(), key=lambda kv: -kv[1]))}")
        print("beam occ-count per fb read: median "
              f"{np.median(nocc_sizes) if nocc_sizes else 0}, "
              f"p90 {np.percentile(nocc_sizes, 90) if nocc_sizes else 0}")


if __name__ == "__main__":
    main()
