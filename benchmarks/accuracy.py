"""Alignment accuracy evaluation (wgsim-style, SURVEY.md §4 validation).

Simulates reads with known origins (mismatches + indels at set rates),
runs the full single-end PRODUCTION pipeline (pigeon + gapped verify +
beam fallback via Aligner), and reports placement accuracy overall and
at MAPQ>=20 — the external-validation methodology the reference
lineage's publications used, since the repo itself ships no tests.

HSA_BENCH_GENOME_MODEL=repeats runs the repeat-structured genome model
(Alu-like families, segmental duplications, tandem repeats) that
stresses multi-hit and fallback behavior the i.i.d. model cannot.
"""

import os

import numpy as np
from common import CACHE, cached_index, report, setup_jax

N = int(os.environ.get("HSA_BENCH_ACC_BP", "16000000"))
B = int(os.environ.get("HSA_BENCH_ACC_READS", "2000"))
MODEL = os.environ.get("HSA_BENCH_GENOME_MODEL", "iid")
L = 100


def main():
    setup_jax()
    from hsa_tpu import alphabet
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner

    di, text = cached_index(f"acc_{N // 1_000_000}M", N, model=MODEL)
    text = np.asarray(text, np.int8)
    opt = AlnOpt(max_diff=2)
    kdir = os.path.join(CACHE,
                        f"idxdir_acc_{N // 1_000_000}M_{MODEL}")
    os.makedirs(kdir, exist_ok=True)
    al = Aligner.from_arrays(di, text, opt=opt, ladder=[8, 64, 512],
                             engine="auto", index_dir=kdir)

    rs = np.random.RandomState(11)
    reads, truth = [], []
    for j in range(B):
        p = rs.randint(0, N - L - 3)
        kind = j % 8
        r = np.asarray(text[p:p + L + (1 if kind == 6 else 0)]).copy()
        nerr = [0, 1, 1, 2, 2, 2, 0, 0][kind]
        for _ in range(nerr):
            q = rs.randint(0, L)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        if kind == 6:  # 1bp deletion in read
            cut = rs.randint(10, L - 10)
            r = np.concatenate([r[:cut], r[cut + 1:]])
        elif kind == 7:  # 1bp insertion in read
            cut = rs.randint(10, L - 10)
            r = np.concatenate([r[:cut], [rs.randint(0, 4)], r[cut:]])[:L]
        if j % 2:  # half on the reverse strand
            r = alphabet.revcomp(r.astype(np.int8))
        reads.append(r.astype(np.int8))
        truth.append(p)

    recs = al.align(reads, read_offset=0)
    ok = ok20 = n20 = mapped = 0
    for j, rec in enumerate(recs):
        if rec.flag & 4:
            continue
        mapped += 1
        correct = abs((rec.pos - 1) - truth[j]) <= 3  # indel wobble tolerance
        ok += correct
        if rec.mapq >= 20:
            n20 += 1
            ok20 += correct
    report("accuracy_correct_frac", ok / max(mapped, 1), "fraction",
           reads=B, mapped=mapped, genome_model=MODEL,
           mapped_frac=round(mapped / B, 4),
           fallback_frac=round(getattr(al, "last_fallback_frac", 0.0), 4),
           mapq20_n=n20, mapq20_correct=round(ok20 / max(n20, 1), 4))


if __name__ == "__main__":
    main()
