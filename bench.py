"""Headline benchmark: END-TO-END alignment throughput, k=2 mismatches,
100bp reads, both strands.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

Scope: the headline times the FULL production
path per batch — host read packing, the both-strand device pigeon search
(fallback beam ladder included), host finalization/resolution, and SAM
text emission — exactly what `hsa-tpu align` does per batch, minus file
I/O.  The device kernel alone is reported separately as
``device_step_reads_s`` (both strands) so the host/device split is
visible; round 2's headline was the single-strand device step only.

Configuration mirrors the north-star metric ("reads/s per device at k=2
mismatches on a human-scale reference").  The genome is synthetic, made
from a seed (i.i.d. by default; HSA_BENCH_GENOME_MODEL=repeats for the
repeat-structured model in benchmarks/common.py).

Measurement discipline:
- every timed iteration ends in a host readback of its result;
- compile/warmup excluded, reported separately.

``vs_baseline``: BASELINE.json carries no published numbers; the
denominator is the documented stand-in constant
BASELINE_READS_PER_S = 2000 (single-threaded CPU lineage-class estimate
for this config), so the ratio tracks round-over-round progress against
a fixed yardstick.
"""

import json
import os
import sys
import time

import numpy as np

GENOME_MBP = int(os.environ.get("HSA_BENCH_GENOME_MBP", "64"))
GENOME_MODEL = os.environ.get("HSA_BENCH_GENOME_MODEL", "iid")
SA_INTV = int(os.environ.get("HSA_BENCH_SA_INTV", "8"))
# B=16K: shorter device steps interleave with host resolve in the
# depth-2 pipeline (batch size not yet tuned on the H100)
BATCH = int(os.environ.get("HSA_BENCH_BATCH", "16384"))
READ_LEN = int(os.environ.get("HSA_BENCH_READ_LEN", "100"))
LADDER = tuple(int(x) for x in
               os.environ.get("HSA_BENCH_LADDER", "8,64").split(",") if x)
ITERS = int(os.environ.get("HSA_BENCH_ITERS", "6"))
REPS = int(os.environ.get("HSA_BENCH_REPS", "3"))
ENGINE = os.environ.get("HSA_BENCH_ENGINE", "auto")
BASELINE_READS_PER_S = 2000.0
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from hsa_tpu.cache import ROOT  # noqa: E402

CACHE = os.path.join(ROOT, "bench")


def get_index():
    from hsa_tpu.index.layout import DeviceIndex, build_device_index

    os.makedirs(CACHE, exist_ok=True)
    tag = "" if GENOME_MODEL == "iid" else f"_{GENOME_MODEL}"
    idx_path = os.path.join(CACHE, f"idx_{GENOME_MBP}M{tag}_v4b_s{SA_INTV}.npz")
    txt_path = os.path.join(CACHE, f"txt_{GENOME_MBP}M{tag}.npy")
    if os.path.exists(idx_path) and os.path.exists(txt_path):
        try:
            return DeviceIndex.load(idx_path), np.load(txt_path, mmap_mode="r")
        except ValueError:
            pass  # stale layout version: rebuild below
    n = GENOME_MBP * 1_000_000
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "benchmarks"))
    from common import synth_genome
    t = synth_genome(n, GENOME_MODEL)
    di = build_device_index(t, sa_intv=SA_INTV, with_reverse=True)
    di.save(idx_path)
    np.save(txt_path, t)
    return di, t


def make_reads(text, n_genome):
    """BATCH reads planted with k=2 mismatches; half on the reverse strand
    (the production workload both-strand lanes must resolve)."""
    from hsa_tpu.pipeline import ReadBatch
    rs = np.random.RandomState(1)
    mat = np.empty((BATCH, READ_LEN), np.uint8)
    for j in range(BATCH):
        p = rs.randint(0, n_genome - READ_LEN)
        r = np.asarray(text[p:p + READ_LEN]).copy()
        for _ in range(2):
            q = rs.randint(0, READ_LEN)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        if j % 2:
            r = (3 - r)[::-1].copy()   # reverse strand
        mat[j] = r
    return ReadBatch(mat, np.full(BATCH, READ_LEN, np.int32))


def _secondary_row(model: str, mbp: int, opt, allow_build: bool,
                   iters: int | None = None):
    """One-campaign e2e reads/s on a secondary (north-star) config.

    Uses the cached index only (unless ``allow_build`` and the genome is
    small); returns None when unavailable — the driver JSON then shows
    the row as null rather than hiding it.
    """
    import gc
    import time as _t
    from hsa_tpu.index.layout import DeviceIndex, build_device_index
    from hsa_tpu.pipeline import Aligner
    gc.collect()
    tag = "" if model == "iid" else f"_{model}"
    idx_path = os.path.join(CACHE, f"idx_{mbp}M{tag}_v4b_s{SA_INTV}.npz")
    txt_path = os.path.join(CACHE, f"txt_{mbp}M{tag}.npy")
    if not (os.path.exists(idx_path) and os.path.exists(txt_path)):
        if not (allow_build and mbp <= 64):
            return None
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "benchmarks"))
        from common import synth_genome
        t = synth_genome(mbp * 1_000_000, model)
        di = build_device_index(t, sa_intv=SA_INTV, with_reverse=True)
        di.save(idx_path)
        np.save(txt_path, t)
    try:
        di = DeviceIndex.load(idx_path)
        text = np.asarray(np.load(txt_path, mmap_mode="r"), np.int8)
    except (ValueError, MemoryError):
        return None
    kdir = os.path.join(CACHE, f"idxdir_{mbp}M{tag}_s{SA_INTV}")
    os.makedirs(kdir, exist_ok=True)
    al = Aligner.from_arrays(di, text, opt=opt, ladder=list(LADDER),
                             engine=ENGINE, index_dir=kdir)
    reads = make_reads(text, di.n)
    al.align(reads, read_offset=0)          # warm/compile + profile settle
    it = iters or ITERS
    # settle with one FULL campaign: the pooled-escalation shape classes
    # depend on the campaign length (12 batches pool a different retry/
    # beam pad than 2), and even persistent-cache loads of those
    # programs cost seconds when they land inside the timed campaign
    for _s, _lf in al.align_stream(
            ((i * BATCH, None, reads, None) for i in range(it)),
            emit="sam"):
        pass
    # MEDIAN of REPS campaign means — same convention as the headline
    means = []
    for _rep in range(REPS):
        ts = [_t.time()]
        for _s, _lf in al.align_stream(
                ((i * BATCH, None, reads, None) for i in range(it)),
                emit="sam"):
            ts.append(_t.time())
        means.append(float(np.diff(ts).mean()))
    dt = float(np.median(means))
    del al, di, text, reads
    gc.collect()
    return round(BATCH / dt, 1)


def main():
    import jax

    from hsa_tpu.cache import enable_compile_cache
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner

    enable_compile_cache()

    t0 = time.time()
    di, text = get_index()
    text = np.asarray(text, np.int8)
    index_load_s = time.time() - t0

    tag = "" if GENOME_MODEL == "iid" else f"_{GENOME_MODEL}"
    kdir = os.path.join(CACHE, f"idxdir_{GENOME_MBP}M{tag}_s{SA_INTV}")
    os.makedirs(kdir, exist_ok=True)
    opt = AlnOpt(max_diff=2)
    aligner = Aligner.from_arrays(di, text, opt=opt, ladder=list(LADDER),
                                  engine=ENGINE, index_dir=kdir)
    reads = make_reads(text, di.n)

    # warmup/compile (one full batch through the pipeline)
    t0 = time.time()
    recs = aligner.align(reads, read_offset=0)
    sam = "\n".join(r.to_sam() for r in recs)
    compile_s = time.time() - t0
    mapped = sum(1 for r in recs if not (r.flag & 4)) / len(recs)

    # device-step metric (pack + both-strand pigeon search + readback)
    n_seg, elig = aligner._pigeon_split(reads)
    prof = aligner._pigeon_profile     # repeat-profile caps if the warmup
    if prof != "base":                 # batch upshifted (adaptive, r4)
        aligner._pigeon_raw(reads, n_seg, prof)   # compile outside timing
    t0 = time.time()
    for _ in range(ITERS):
        res = aligner._pigeon_raw(reads, n_seg, prof)
        _ = np.asarray(res.pos[:8])
    dev_dt = (time.time() - t0) / ITERS
    from hsa_tpu.search import pigeon as pg
    t0 = time.time()
    for _ in range(ITERS):
        occ, fb, _miss = pg.pigeon_occ_arrays(res, len(reads), opt,
                                       aligner._pigeon_caps(prof)[1])
    fin_dt = (time.time() - t0) / ITERS

    # settle pass: two untimed stream batches so every steady-state shape
    # class — upshifted-profile main search, seg_phase retry pads, pooled
    # beam fallback pads — is compiled BEFORE the campaigns (the adaptive
    # upshift lands after the warmup batch, so its dependent shapes would
    # otherwise compile inside the first timed iteration)
    for _s, _lf in aligner.align_stream(
            ((i * BATCH, None, reads, None) for i in range(2)), emit="sam"):
        pass

    prof_dir = os.environ.get("HSA_BENCH_PROFILE")
    if prof_dir:
        with jax.profiler.trace(prof_dir):
            recs = aligner.align(reads, read_offset=0)
            _ = len(recs)

    # end-to-end timed loop: pipelined align_stream + SAM text per batch
    # (same flow as `hsa-tpu align`: batch n+1's device work overlaps
    # batch n's host resolution).  REPS independent campaigns; the
    # HEADLINE is the MEDIAN campaign mean (a single campaign mean over-
    # or under-states by luck) with the best batch labeled separately.
    def batches():
        for it in range(ITERS):
            yield it * BATCH, None, reads, None

    rep_means = []
    deltas_all = []
    for _rep in range(REPS):
        iter_ts = [time.time()]
        for _s, (lines, flags) in aligner.align_stream(batches(), emit="sam"):
            sam = "\n".join(lines)
            iter_ts.append(time.time())
        deltas = np.diff(iter_ts)
        rep_means.append(float(deltas.mean()))
        deltas_all.append(deltas)
        assert len(sam) > 0
    deltas = np.concatenate(deltas_all)
    dt = float(np.median(rep_means))
    dt_min = float(deltas.min())

    # occ-gather microbench (chained scan; rate of the hot primitive)
    from jax import lax
    import jax.numpy as jnp
    from hsa_tpu.search import fm
    from hsa_tpu.search.jitcache import split_idx, join_idx
    arrays, meta_ = split_idx(aligner.dev)

    @jax.jit
    def occ_chain(arrs, p):
        idx = join_idx(meta_, arrs)

        def body(p, _):
            o = fm.occ_lt4_flat(idx, p)
            return (o[0] ^ o[3]) & jnp.uint32((1 << 25) - 1), None
        p, _ = lax.scan(body, p, None, length=32)
        return p

    Q = 1 << 20
    qs = jnp.asarray(np.random.RandomState(3).randint(
        0, di.n, Q).astype(np.uint32))
    o = occ_chain(arrays, qs)
    _ = np.asarray(o[:2])
    t0 = time.time()
    o = occ_chain(arrays, o)
    _ = np.asarray(o[:2])
    occ_dt = (time.time() - t0) / 32
    occ_qps = Q / occ_dt

    # ---- secondary rows: the north-star configs (VERDICT r4 weak #3) ----
    # the headline genome is 64 Mbp i.i.d.; the metric names the HUMAN
    # reference, and the only genome model that behaves like real input
    # is the repeats model — so the driver-visible JSON carries one-
    # campaign rows for both (cached indexes only; a missing 3.1 Gbp
    # cache SKIPS the row rather than triggering a 72-min rebuild).
    fallback_frac = round(getattr(aligner, "last_fallback_frac", 0.0), 4)
    trunc_frac = round(getattr(aligner, "last_trunc_frac", 0.0), 4)
    retry_frac = round(getattr(aligner, "last_retry_frac", 0.0), 4)
    pigeon_profile = aligner._pigeon_profile
    extras = {}
    if (GENOME_MODEL == "iid" and GENOME_MBP == 64
            and os.environ.get("HSA_BENCH_SECONDARY", "1") != "0"):
        del aligner, reads
        # 12 iterations: repeat-dense streams pool their escalations
        # (seg_phase retry + widest-rung beam) across ~12-16 batches, so
        # short campaigns overstate the per-batch flush share
        extras["repeats_reads_s"] = _secondary_row(
            "repeats", 64, opt, allow_build=True, iters=12)
        extras["human_scale_reads_s"] = _secondary_row(
            "iid", 3100, opt, allow_build=False)

    reads_per_s = BATCH / dt
    print(json.dumps({
        "metric": "reads_per_s_e2e_2strand_k2_100bp",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "scope": "host pack + device search + resolve + SAM text",
        "genome_mbp": GENOME_MBP,
        "genome_model": GENOME_MODEL,
        "batch": BATCH,
        "read_len": READ_LEN,
        "engine": ENGINE,
        "ladder": list(LADDER),
        "mapped_frac": round(mapped, 4),
        "fallback_frac": fallback_frac,
        "trunc_frac": trunc_frac,
        "retry_frac": retry_frac,
        "pigeon_profile": pigeon_profile,
        "batch_ms": round(dt * 1e3, 1),
        "batch_ms_min": round(dt_min * 1e3, 1),
        "campaign_means_ms": [round(m * 1e3, 1) for m in rep_means],
        "reads_per_s_best": round(BATCH / dt_min, 1),
        "device_step_reads_s": round(BATCH / dev_dt, 1),
        "device_step_ms": round(dev_dt * 1e3, 1),
        "finalize_ms": round(fin_dt * 1e3, 1),
        "occ_mqueries_per_s": round(occ_qps / 1e6, 1),
        "compile_s": round(compile_s, 1),
        "index_load_s": round(index_load_s, 1),
        "device": str(jax.devices()[0]),
        **extras,
    }))


if __name__ == "__main__":
    main()
