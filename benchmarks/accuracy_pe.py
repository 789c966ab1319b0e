"""Paired-end accuracy evaluation (wgsim-style; the PE twin of
accuracy.py — SURVEY.md §4 validation methodology).

Simulates FR fragments with known origins (mismatches on both ends, a
1bp-indel class, a rescue class whose second end exceeds the search
budget), runs the full production paired pipeline (pigeon both ends +
pairing + insert inference + mate rescue + paired MAPQ), and reports:
end placement accuracy, proper-pair rate, rescue yield, and the
MAPQ>=20 confident-call accuracy.

HSA_BENCH_GENOME_MODEL=repeats stresses the discordant-rescue and
multi-mapping paths the i.i.d. model cannot.
"""

import os

import numpy as np
from common import CACHE, cached_index, report, setup_jax

N = int(os.environ.get("HSA_BENCH_ACC_BP", "16000000"))
P = int(os.environ.get("HSA_BENCH_ACC_PAIRS", "1000"))
MODEL = os.environ.get("HSA_BENCH_GENOME_MODEL", "iid")
L = 100
ISIZE = 300


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
    reads1, reads2, true1, true2, kinds = [], [], [], [], []
    for j in range(P):
        p = rs.randint(0, N - ISIZE - 10)
        frag = text[p:p + ISIZE].copy()
        kind = j % 4
        if kind == 0:                  # 2 mismatches per end
            for qq in (rs.randint(0, L), rs.randint(0, L)):
                frag[qq] = (frag[qq] + rs.randint(1, 4)) % 4
            for qq in (rs.randint(0, L), rs.randint(0, L)):
                i2 = ISIZE - L + qq
                frag[i2] = (frag[i2] + rs.randint(1, 4)) % 4
            r1 = frag[:L]
            r2f = frag[-L:]
        elif kind == 1:                # clean pair
            r1 = frag[:L]
            r2f = frag[-L:]
        elif kind == 2:                # 1bp deletion in end 1
            w = text[p:p + L + 1].copy()
            r1 = np.delete(w, L // 2)
            r2f = frag[-L:]
        else:                          # rescue class: end 2 with 5 mm
            r1 = frag[:L]
            r2f = frag[-L:].copy()
            for qq in rs.choice(L, 5, replace=False):
                r2f[qq] = (r2f[qq] + rs.randint(1, 4)) % 4
        reads1.append(np.asarray(r1, np.int8))
        reads2.append(alphabet.revcomp(np.asarray(r2f, np.int8)))
        true1.append(p)
        true2.append(p + ISIZE - L)
        kinds.append(kind)

    recs = al.align_pe(reads1, reads2,
                       [f"pair{j}" for j in range(P)])
    starts = np.asarray(al.meta.starts, np.int64)

    def pos0(rec):
        if rec.flag & 4 or rec.rname == "*":
            return -1
        ri = al.meta.names.index(rec.rname)
        return int(starts[ri]) + rec.pos - 1

    n_mapped = n_correct = n_proper = n_resc = n_resc_ok = 0
    q20_n = q20_ok = 0
    for j in range(P):
        r1, r2 = recs[2 * j], recs[2 * j + 1]
        for rec, tp in ((r1, true1[j]), (r2, true2[j])):
            p0 = pos0(rec)
            if p0 < 0:
                continue
            n_mapped += 1
            ok = abs(p0 - tp) <= 8     # indel/rescue placement slack
            n_correct += ok
            if rec.mapq >= 20:
                q20_n += 1
                q20_ok += ok
        if r1.flag & 2:
            n_proper += 1
        if r2.tags.get("XT") == "M" or r1.tags.get("XT") == "M":
            n_resc += 1
            p0 = pos0(r2 if r2.tags.get("XT") == "M" else r1)
            tp = true2[j] if r2.tags.get("XT") == "M" else true1[j]
            n_resc_ok += abs(p0 - tp) <= 8

    report("pe_accuracy_correct_frac",
           round(n_correct / max(n_mapped, 1), 4), "fraction",
           pairs=P, genome_model=MODEL,
           mapped_end_frac=round(n_mapped / (2 * P), 4),
           proper_frac=round(n_proper / P, 4),
           rescued=n_resc, rescued_correct=n_resc_ok,
           mapq20_n=q20_n,
           mapq20_correct=round(q20_ok / max(q20_n, 1), 4))


if __name__ == "__main__":
    main()
