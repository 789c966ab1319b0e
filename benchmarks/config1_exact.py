"""Config 1: exact-match search, 100bp reads vs E. coli K-12
scale (4.6 Mbp), replicated FM-index, one device.

The workload routes through the pigeon engine with a single
segment and budget 0 — one K-mer-seeded anchor, direct-SA locate, and a
packed window verify (nmm must be 0) — the exact-match special case of
the production path.  Set HSA_BENCH_C1_ENGINE=scan for the classic
full-length backward scan (`search/exact.py`).
"""

import os
import numpy as np
from common import cached_index, report, sample_reads, setup_jax, timeit

N = int(os.environ.get("HSA_BENCH_C1_MBP", "4600000"))
B = int(os.environ.get("HSA_BENCH_BATCH", "32768"))
L = 100
ENGINE = os.environ.get("HSA_BENCH_C1_ENGINE", "pigeon")


def main():
    jax = setup_jax()
    import jax.numpy as jnp

    di, text = cached_index("ecoli_4M6", N, with_reverse=False)
    dev = di.as_jax()
    fwd = sample_reads(text, B, L)
    lens = np.full(B, L, np.int32)
    from hsa_tpu.search.jitcache import jit_over_idx

    if ENGINE == "pigeon":
        from hsa_tpu.search import pigeon as pg
        from hsa_tpu.search.exact import kmer_table
        from hsa_tpu.config import AlnOpt
        K = 12
        opt = AlnOpt(max_diff=0, max_gapo=0)
        tk, tl = kmer_table(dev, K)
        trows = jnp.asarray(pg.pack_text_rows(np.asarray(text)))
        b = pg.pack_pigeon_batch((fwd, lens), n_seg=1, kmer_k=K,
                                 anchor_tail=pg.auto_anchor_tail(N, K))
        md = jnp.zeros(B, jnp.int32)
        args = {k: jnp.asarray(v) for k, v in b.items()}

        def _step(ix, segs, slens, soff, rw, nm, vm, sm, plens, md, tk, tl,
                  km, ko, ss):
            return pg.pigeon_search(ix, trows, segs, slens, soff, rw, nm,
                                    vm, sm, plens, md, opt, n_seg=1,
                                    cand_cap=8,
                                    kmer_seed=(tk, tl, km, ko, ss))

        step = jit_over_idx(dev, _step)
        dt, res = timeit(step, args["segs_rev"], args["seg_lens"],
                         args["seg_off"], args["rw"], args["nmask"],
                         args["vmask"], args["seedmask"], args["lens"],
                         md, tk, tl, args["kmer"], args["kmer_ok"],
                         args["seg_short"])
        matched = float(np.unique(np.asarray(res.cidx)[np.asarray(res.valid)]
                               // 8).size) / B
        report("exact_reads_per_s", B / dt, "reads/s",
               genome_mbp=N // 1_000_000, batch=B, engine="pigeon",
               matched_frac=round(matched, 4), batch_ms=round(dt * 1e3, 1))
    else:
        from hsa_tpu.search.exact import exact_search, locate_all
        reads_rev = fwd[:, ::-1].copy()

        def _step(ix, rr, ln):
            k, l, m = exact_search(ix, rr, ln)
            pos, cnt = locate_all(ix, k, l, m, cap=1)
            return k, l, m, pos

        step = jit_over_idx(dev, _step)
        dt, (k, l, m, pos) = timeit(step, jnp.asarray(reads_rev),
                                    jnp.asarray(lens))
        report("exact_reads_per_s", B / dt, "reads/s",
               genome_mbp=N // 1_000_000, batch=B, engine="scan",
               matched_frac=round(float(np.asarray(m).mean()), 4),
               batch_ms=round(dt * 1e3, 1))

def e2e():
    """Production-path e2e companion metric (Aligner: both strands,
    resolution + SAM text; second JSON line)."""
    setup_jax()
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner, ReadBatch
    di, text = cached_index("ecoli_4M6_full", N)
    text = np.asarray(text, np.int8)
    opt = AlnOpt(max_diff=0, max_gapo=0)
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                             engine="auto")
    fwd = sample_reads(text, B, L)
    reads = ReadBatch(fwd, np.full(B, L, np.int32))
    recs = al.align(reads)
    mapped = sum(1 for r in recs if not (r.flag & 4)) / len(recs)
    from common import stream_campaigns
    dt, means = stream_campaigns(al, reads, B)
    report("exact_reads_per_s_e2e", B / dt, "reads/s",
           genome_mbp=round(N / 1e6, 1), batch=B,
           scope="e2e 2-strand: pack+search+resolve+SAM",
           mapped_frac=round(mapped, 4), batch_ms=round(dt * 1e3, 1),
           campaign_means_ms=[round(m * 1e3, 1) for m in means])


if __name__ == "__main__":
    main()
    e2e()
