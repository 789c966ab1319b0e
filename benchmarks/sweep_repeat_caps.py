"""Sweep (seg_cap, cand_cap, pool_mult) on the repeats genome: screen
quality (fallback / trunc fractions) vs device-step cost (round 4)."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from common import CACHE, setup_jax  # noqa: E402

B = int(os.environ.get("HSA_BENCH_BATCH", "16384"))
L = 100
COMBOS = [(32, 48, 8), (48, 96, 8), (64, 128, 12), (96, 160, 16)]


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
    reads = ReadBatch(mat, np.full(B, L, np.int32))

    for seg_cap, cc, pm in COMBOS:
        al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                                 engine="auto", index_dir=kdir)
        al._PIGEON_SEG_CAP = seg_cap
        al._PIGEON_CAND_CAP = cc
        al._PIGEON_POOL_MULT = pm
        n_seg, elig = al._pigeon_split(reads)
        res = al._pigeon_raw(reads, n_seg)          # compile+warm
        t0 = time.time()
        for _ in range(3):
            res = al._pigeon_raw(reads, n_seg)
        dt = (time.time() - t0) / 3
        occ, fb, missed = pg.pigeon_occ_arrays(res, B, opt, cc)
        has_occ = np.zeros(B, bool)
        if occ["rid"].size:
            has_occ[np.unique(occ["rid"])] = True
        fb_eff = fb | ((missed > 0) & ~has_occ)
        print(f"seg_cap={seg_cap:4d} cc={cc:4d} pm={pm} "
              f"device_ms={dt*1e3:7.1f} fallback={fb_eff.mean():.4f} "
              f"trunc={(~fb_eff & (missed > 0)).mean():.4f} "
              f"occ_entries={len(occ['rid'])}", flush=True)


if __name__ == "__main__":
    main()
