"""Host-resolve profiler for the gapped config: attributes the host
resolution time of one config-3 batch with cProfile."""
import cProfile
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from common import CACHE, cached_index, sample_reads, setup_jax  # noqa: E402

N = int(os.environ.get("HSA_BENCH_C3_BP", "46700000"))
B = int(os.environ.get("HSA_BENCH_BATCH", "16384"))
L = 100


def main():
    setup_jax()
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner, ReadBatch
    from hsa_tpu.search import pigeon as pg
    from hsa_tpu.resolve.samse import resolve_from_occ_arrays

    di, text = cached_index("chr21_46M", N)
    text = np.asarray(text, np.int8)
    opt = AlnOpt()
    kdir = os.path.join(CACHE,
                        "idxdir_chr21_46M")
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                             engine="auto", index_dir=kdir)
    fwd = sample_reads(text, B, L, n_mm=2, indel=True)
    reads = ReadBatch(fwd, np.full(B, L, np.int32))
    n_seg, elig = al._pigeon_split(reads)
    res = al._pigeon_raw(reads, n_seg)
    occ, fb, miss = pg.pigeon_occ_arrays(res, B, opt, al._PIGEON_CAND_CAP)
    names = [f"r{i}" for i in range(B)]

    t0 = time.time()
    resolve_from_occ_arrays(text, al.meta, reads, names, None, occ,
                            [False] * B, opt, emit="sam")
    print(f"one resolve: {(time.time() - t0) * 1e3:.1f} ms", flush=True)

    pr = cProfile.Profile()
    pr.enable()
    for _ in range(3):
        resolve_from_occ_arrays(text, al.meta, reads, names, None, occ,
                                [False] * B, opt, emit="sam")
    pr.disable()
    st = pstats.Stats(pr)
    st.sort_stats("cumulative").print_stats(28)


if __name__ == "__main__":
    main()
