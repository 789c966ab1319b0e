"""Config 3: full gapped inexact search (mismatch+indel budget) vs
human chr21 scale (46 Mbp), 1 host.

Runs the PRODUCTION path end-to-end — the pigeon engine with one-run
gapped device verify (fnr budget 5 -> 6 segments, gap runs up to 5) plus
the beam ladder for structural fallbacks, through Aligner.align_stream
(pipelined host/device overlap), records included.
"""

import os
import time
import numpy as np
from common import CACHE, cached_index, report, sample_reads, setup_jax

N = int(os.environ.get("HSA_BENCH_C3_BP", "46700000"))
# batch size not yet tuned on the H100
B = int(os.environ.get("HSA_BENCH_BATCH", "8192"))
L = 100
ITERS = int(os.environ.get("HSA_BENCH_ITERS", "4"))


def main():
    setup_jax()
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner, ReadBatch

    di, text = cached_index("chr21_46M", N)
    text = np.asarray(text, np.int8)
    opt = AlnOpt()  # fnr budgets, gaps enabled (defaults): md=5 at 100bp
    kdir = os.path.join(CACHE,
                        "idxdir_chr21_46M")
    os.makedirs(kdir, exist_ok=True)
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                             engine="auto", index_dir=kdir)
    fwd = sample_reads(text, B, L, n_mm=2, indel=True)
    reads = ReadBatch(fwd, np.full(B, L, np.int32))

    recs = al.align(reads, read_offset=0)   # warm/compile
    mapped = sum(1 for r in recs if not (r.flag & 4)) / len(recs)

    stages = {}
    if os.environ.get("HSA_BENCH_C3_STAGES"):
        # per-stage attribution (VERDICT r3 #2): device step / host
        # finalize / record resolution, plus a max_gapo=0 twin whose
        # device-step delta isolates the gapped screen's cost
        from hsa_tpu.search import pigeon as pg
        from hsa_tpu.resolve.samse import resolve_from_occ_arrays
        n_seg, elig = al._pigeon_split(reads)
        res = al._pigeon_raw(reads, n_seg)           # warm
        t0 = time.time()
        for _ in range(ITERS):
            res = al._pigeon_raw(reads, n_seg)
        stages["device_ms"] = (time.time() - t0) / ITERS * 1e3
        t0 = time.time()
        for _ in range(ITERS):
            occ, fb, miss = pg.pigeon_occ_arrays(res, B, opt,
                                                 al._PIGEON_CAND_CAP)
        stages["finalize_ms"] = (time.time() - t0) / ITERS * 1e3
        t0 = time.time()
        for _ in range(ITERS):
            out = resolve_from_occ_arrays(text, al.meta, reads,
                                          [f"r{i}" for i in range(B)], None,
                                          occ, [False] * B, opt, emit="sam")
        stages["resolve_ms"] = (time.time() - t0) / ITERS * 1e3
        # gapped-screen delta: same engine with gaps disabled
        from hsa_tpu.config import AlnOpt as _A
        opt0 = _A(max_gapo=0)
        al0 = Aligner.from_arrays(di, text, opt=opt0, ladder=[8, 64],
                                  engine="auto", index_dir=kdir)
        al0._pigeon_raw(reads, n_seg)                # warm/compile
        t0 = time.time()
        for _ in range(ITERS):
            al0._pigeon_raw(reads, n_seg)
        stages["device_nogap_ms"] = (time.time() - t0) / ITERS * 1e3
        stages = {k: round(v, 1) for k, v in stages.items()}

    # settle + median-of-3 campaigns on the production emit="sam" path
    # (the previous records-mode single campaign both paid first-campaign
    # compiles and re-stringified records the direct-SAM path avoids)
    from common import stream_campaigns
    dt, means = stream_campaigns(al, reads, B, iters=ITERS)
    report("gapped_reads_per_s", B / dt, "reads/s",
           genome_mbp=round(N / 1e6, 1), batch=B, engine="pigeon+gapped",
           scope="e2e 2-strand: pack+search+resolve+SAM",
           max_diff=int(opt.diff_budget(L)),
           mapped_frac=round(mapped, 4),
           fallback_frac=round(getattr(al, "last_fallback_frac", 0.0), 4),
           batch_ms=round(dt * 1e3, 1),
           campaign_means_ms=[round(m * 1e3, 1) for m in means], **stages)


if __name__ == "__main__":
    main()
