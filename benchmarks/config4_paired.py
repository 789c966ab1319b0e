"""Config 4: paired-end 150bp reads vs whole-human-scale genome,
1 host.

"Whole human" is approximated at HSA_BENCH_C4_MBP (default 250 Mbp — a
chr1-scale synthetic genome; the 3.1 Gbp build is a one-time SA-IS run,
enabled by env var when the round budget allows).

Runs the PRODUCTION paired path end-to-end — both ends through the
pigeon engine (150bp inside the engine's 160bp window; one-run gapped
verify on), pairing + insert-size inference + mate rescue + paired MAPQ,
SAM records out.
"""

import os
import time
import numpy as np
from common import CACHE, cached_index, report, setup_jax

N = int(os.environ.get("HSA_BENCH_C4_MBP", "250")) * 1_000_000
# batch size not yet tuned on the H100
B = int(os.environ.get("HSA_BENCH_PAIRS", "4096"))  # pairs
L = 150
# 6 iters/campaign: the depth-2 pipeline needs a few batches to amortize
# its fill
ITERS = int(os.environ.get("HSA_BENCH_ITERS", "6"))
REPS = int(os.environ.get("HSA_BENCH_REPS", "3"))


def main():
    setup_jax()
    from hsa_tpu import alphabet
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner

    if N >= 1_000_000_000:
        # whole-human scale: reuse bench.py's 3.1 Gbp sa_intv=8 cache
        # (same synth_genome seed) instead of a second 72-min build
        from hsa_tpu.index.layout import DeviceIndex
        cache = CACHE
        di = DeviceIndex.load(os.path.join(
            cache, f"idx_{N // 1_000_000}M_v4b_s8.npz"))
        text = np.load(os.path.join(cache, f"txt_{N // 1_000_000}M.npy"),
                       mmap_mode="r")
    else:
        di, text = cached_index(f"human_{N // 1_000_000}M", N)
    text = np.asarray(text, np.int8)
    opt = AlnOpt(max_diff=2)
    kdir = os.path.join(CACHE,
                        f"idxdir_human_{N // 1_000_000}M")
    os.makedirs(kdir, exist_ok=True)
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64],
                             engine="auto", index_dir=kdir)

    rs = np.random.RandomState(3)
    isize = 400
    reads1, reads2 = [], []
    for j in range(B):
        p = rs.randint(0, N - isize - 1)
        frag = np.asarray(text[p:p + isize]).copy()
        for _ in range(2):
            q = rs.randint(0, isize)
            frag[q] = (frag[q] + rs.randint(1, 4)) % 4
        reads1.append(frag[:L].astype(np.int8))
        reads2.append(alphabet.revcomp(frag[-L:].astype(np.int8)))

    recs = al.align_pe(reads1, reads2, read_offset=0)   # warm/compile
    mapped = sum(1 for r in recs if not (r.flag & 4)) / len(recs)
    proper = sum(1 for r in recs if r.flag & 2) / len(recs)

    def batches():
        for it in range(ITERS):
            yield it * B, None, reads1, None, reads2, None

    # settle pass: compile any steady-state shape the stream uses
    for _s, _lf in al.align_pe_stream(
            ((0, None, reads1, None, reads2, None),), emit="sam"):
        pass

    rep_means = []
    for _rep in range(REPS):
        t0 = time.time()
        for _s, (lines, flags) in al.align_pe_stream(batches(), emit="sam"):
            sam = "\n".join(lines)
            assert sam
        rep_means.append((time.time() - t0) / ITERS)
    dt = float(np.median(rep_means))   # median campaign
    report("paired_pairs_per_s", B / dt, "pairs/s",
           genome_mbp=N // 1_000_000, pairs=B, read_len=L,
           engine="pigeon+gapped",
           scope="e2e: both ends search+pair+rescue+resolve+SAM",
           mapped_end_frac=round(mapped, 4),
           proper_frac=round(proper, 4),
           fallback_frac=round(getattr(al, "last_fallback_frac", 0.0), 4),
           batch_ms=round(dt * 1e3, 1),
           campaign_means_ms=[round(m * 1e3, 1) for m in rep_means])


if __name__ == "__main__":
    main()
