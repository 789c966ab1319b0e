"""Config 2: 1-mismatch inexact search, 100bp reads vs phiX +
E. coli scale (5.4 Mbp).

Routes through the pigeon engine (2 segments, budget 1) with
mapped/overflow parity semantics; HSA_BENCH_C2_ENGINE=beam runs the
classic width-8 beam instead.
"""

import os
import numpy as np
from common import cached_index, report, sample_reads, setup_jax, timeit

N = int(os.environ.get("HSA_BENCH_C2_BP", "5386000"))
B = int(os.environ.get("HSA_BENCH_BATCH", "32768"))
L = 100
W = 8
ENGINE = os.environ.get("HSA_BENCH_C2_ENGINE", "pigeon")


def main():
    jax = setup_jax()
    import jax.numpy as jnp
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.search.jitcache import jit_over_idx

    di, text = cached_index("phix_ecoli_5M4", N)
    dev = di.as_jax()
    opt = AlnOpt(max_diff=1, max_gapo=0)
    fwd = sample_reads(text, B, L, n_mm=1)
    lens = np.full(B, L, np.int32)

    if ENGINE == "pigeon":
        from hsa_tpu.search import pigeon as pg
        from hsa_tpu.search.exact import kmer_table
        K = 12
        tk, tl = kmer_table(dev, K)
        trows = jnp.asarray(pg.pack_text_rows(np.asarray(text)))
        b = pg.pack_pigeon_batch((fwd, lens), n_seg=2, kmer_k=K,
                                 anchor_tail=pg.auto_anchor_tail(N, K))
        md = jnp.ones(B, jnp.int32)
        args = {k: jnp.asarray(v) for k, v in b.items()}

        def _step(ix, segs, slens, soff, rw, nm, vm, sm, plens, md, tk, tl,
                  km, ko, ss):
            return pg.pigeon_search(ix, trows, segs, slens, soff, rw, nm,
                                    vm, sm, plens, md, opt, n_seg=2,
                                    cand_cap=16,
                                    kmer_seed=(tk, tl, km, ko, ss))

        step = jit_over_idx(dev, _step)
        dt, res = timeit(step, args["segs_rev"], args["seg_lens"],
                         args["seg_off"], args["rw"], args["nmask"],
                         args["vmask"], args["seedmask"], args["lens"],
                         md, tk, tl, args["kmer"], args["kmer_ok"],
                         args["seg_short"])
        mapped = float(np.unique(np.asarray(res.cidx)[np.asarray(res.valid)]
                               // 16).size) / B
        fb = int(np.asarray(res.fallback).sum())
        report("onemm_reads_per_s", B / dt, "reads/s",
               genome_mbp=round(N / 1e6, 1), batch=B, engine="pigeon",
               mapped_frac=round(mapped, 4), fallback_reads=fb,
               batch_ms=round(dt * 1e3, 1))
    else:
        from hsa_tpu.search.beam import beam_search
        from hsa_tpu.search.widths import cal_width_device
        md = np.full(B, 1, np.int32)

        def _step(ix, rf, ln, md):
            D = cal_width_device(ix, rf, ln)
            return beam_search(ix, rf, ln, D, md, opt, beam_width=W,
                               max_hits=16)

        step = jit_over_idx(dev, _step)
        dt, res = timeit(step, jnp.asarray(fwd), jnp.asarray(lens),
                         jnp.asarray(md))
        from hsa_tpu.search.adaptive import finalize_any
        res = finalize_any(res, opt.s_mm)
        mapped = float(np.asarray(res.hit_valid).any(axis=1).mean())
        over = int((np.asarray(res.n_live_dropped) > 0).sum())
        report("onemm_reads_per_s", B / dt, "reads/s",
               genome_mbp=round(N / 1e6, 1), batch=B, engine="beam",
               beam_width=W, mapped_frac=round(mapped, 4),
               overflow_reads=over, batch_ms=round(dt * 1e3, 1))

def e2e():
    """Production-path e2e companion metric (Aligner: both strands,
    resolution + SAM text; second JSON line)."""
    setup_jax()
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner, ReadBatch
    di, text = cached_index("phix_ecoli_5M4", N)
    text = np.asarray(text, np.int8)
    opt = AlnOpt(max_diff=1, max_gapo=0)
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                             engine="auto")
    fwd = sample_reads(text, B, L, n_mm=1)
    reads = ReadBatch(fwd, np.full(B, L, np.int32))
    recs = al.align(reads)
    mapped = sum(1 for r in recs if not (r.flag & 4)) / len(recs)
    from common import stream_campaigns
    dt, means = stream_campaigns(al, reads, B)
    report("onemm_reads_per_s_e2e", B / dt, "reads/s",
           genome_mbp=round(N / 1e6, 1), batch=B,
           scope="e2e 2-strand: pack+search+resolve+SAM",
           mapped_frac=round(mapped, 4), batch_ms=round(dt * 1e3, 1),
           campaign_means_ms=[round(m * 1e3, 1) for m in means])


if __name__ == "__main__":
    main()
    e2e()
