"""Start-up check of the aligner on a GPU, through the entry points a user calls.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded index on four cards only

One card, in this one process: builds the index of a 64 Mbp synthetic
repeats genome with ``hsa_tpu.cli index``; aligns 65,536 single-end 100 bp
reads (pigeon path with its seg_phase retry and pooled beam flush), 4,096 of
them on the beam engine (ladder 8,64) and 16,384 pairs of 2x150 bp, each
through ``hsa_tpu.cli.main``.  It then checks the SAM output: byte-identical
to the same CLI path run on JAX's CPU backend, and equal to the in-repo
oracle on a 256-read sample under the docs/PARITY.md contract.  Keys are
uint32 and DP costs int32, so every comparison is exact.

Four cards: the same index on meshes (1 data x 4 shard) and (4 data x 1
shard); the sharded beam, pigeon and locate functions on 4,096 reads must
equal the single-card results on device 0.

Exits non-zero, without a result line, when JAX finds no GPU or any phase
fails.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Index, reads and SAM files go to .cache/smoke/ inside the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "benchmarks"))

GENOME_BP = 64_000_000
SE_READS, SE_LEN, SE_BATCH = 65_536, 100, 16_384
BEAM_READS = 4_096
PE_PAIRS, PE_LEN, PE_BATCH = 16_384, 150, 4_096
CMP_READS, CMP_PAIRS, ORACLE_READS = 2_048, 512, 256
SHARD_READS = 4_096


def log(msg):
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------- inputs --
def write_fasta(path, g, name):
    """One record, 80 bases per line."""
    b = np.frombuffer(b"ACGT", np.uint8)[g]
    full = len(b) // 80 * 80
    body = np.concatenate([b[:full].reshape(-1, 80),
                           np.full((full // 80, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as fh:
        fh.write(f">{name}\n".encode())
        fh.write(body.tobytes())
        if full < len(b):
            fh.write(b[full:].tobytes() + b"\n")


def write_fastq(path, names, reads):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as fh:
        for n, r in zip(names, reads):
            seq = lut[r].tobytes().decode()
            fh.write(f"@{n}\n{seq}\n+\n{'I' * len(seq)}\n")


def _plant(r, kind, rs, L):
    """The error mix of benchmarks/accuracy.py: 0-2 mismatches, or a 1 bp
    deletion or insertion."""
    for _ in range([0, 1, 1, 2, 2, 2, 0, 0][kind]):
        q = rs.randint(0, L)
        r[q] = (r[q] + rs.randint(1, 4)) % 4
    if kind == 6:
        cut = rs.randint(10, L - 10)
        r = np.concatenate([r[:cut], r[cut + 1:]])
    elif kind == 7:
        cut = rs.randint(10, L - 10)
        r = np.concatenate([r[:cut], [rs.randint(0, 4)], r[cut:]])
    return r[:L].astype(np.int8)


def se_reads(g, n, L, seed=11):
    """n reads of length L (L-1 for deletions), half on the reverse strand."""
    from hsa_tpu import alphabet
    rs = np.random.RandomState(seed)
    out = []
    for j in range(n):
        kind = j % 8
        p = rs.randint(0, len(g) - L - 3)
        r = _plant(g[p:p + L + (kind == 6)].copy(), kind, rs, L)
        out.append(alphabet.revcomp(r) if j % 2 else r)
    return out


def pe_reads(g, n, L, seed=13):
    """n pairs, insert 350 +- 50, FR orientation, read 1 on either strand."""
    from hsa_tpu import alphabet
    rs = np.random.RandomState(seed)
    r1s, r2s = [], []
    for j in range(n):
        ins = int(np.clip(rs.normal(350, 50), L + 10, 600))
        p = rs.randint(0, len(g) - ins)
        a = _plant(g[p:p + L].copy(), j % 6, rs, L)
        b = alphabet.revcomp(_plant(g[p + ins - L:p + ins].copy(),
                                    (j // 6) % 6, rs, L))
        r1s.append(a if j % 2 else b)
        r2s.append(b if j % 2 else a)
    return r1s, r2s


# --------------------------------------------------------------- helpers --
def cli(*args):
    from hsa_tpu import cli as hcli
    rc = hcli.main([str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"hsa_tpu.cli {args[0]} exited {rc}")


def sam_records(path):
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def on_cpu(fn):
    """Run fn with JAX's default device set to the CPU, in every thread
    (the CLI's stream runs device work on worker threads)."""
    import jax
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor
    cpu = jax.devices("cpu")[0]
    jax.config.update("jax_default_device", cpu)
    try:
        with ThreadPoolExecutor(1) as ex:
            placed = ex.submit(lambda: jnp.zeros(1).devices()).result()
        if placed != {cpu}:
            raise RuntimeError(f"worker threads compute on {placed}")
        return fn()
    finally:
        jax.config.update("jax_default_device", None)


def compare(name, got, want):
    bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    log(f"{name}: {len(want)} SAM records, {bad} differ")
    if bad:
        for a, b in zip(got, want):
            if a != b:
                log(f"  got  {a[:200]}\n[smoke]   want {b[:200]}")
                break
        raise RuntimeError(f"{name}: {bad} SAM records differ")


@contextlib.contextmanager
def counting_escalations():
    """Record the read count of every seg_phase retry pass and widest-rung
    beam run the Aligner makes inside the block."""
    from hsa_tpu.pipeline import Aligner
    seen = {"retry": [], "beam": []}
    retry, beam = Aligner._pigeon_retry, Aligner._beam_rerun

    def count_retry(self, sub, ridx, *a, **k):
        seen["retry"].append(len(ridx))
        return retry(self, sub, ridx, *a, **k)

    def count_beam(self, bsub, *a, **k):
        seen["beam"].append(len(bsub))
        return beam(self, bsub, *a, **k)

    Aligner._pigeon_retry, Aligner._beam_rerun = count_retry, count_beam
    try:
        yield seen
    finally:
        Aligner._pigeon_retry, Aligner._beam_rerun = retry, beam


def batch_stats(metrics_path):
    with open(metrics_path) as fh:
        m = json.load(fh)
    bs = m.get("batches", [])
    n = sum(b["n"] for b in bs) or 1
    frac = {k: round(sum(b[k] * b["n"] for b in bs) / n, 4)
            for k in ("fallback", "retry", "trunc")}
    return m, frac


def memory_line(name, lowered):
    ma = lowered.compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    log(f"memory_analysis {name}: "
        + " ".join(f"{f}={getattr(ma, f, None)}" for f in fields))


# --------------------------------------------------------------- one card --
def build_index(work, genome_bp):
    from common import synth_genome
    os.makedirs(work, exist_ok=True)
    g = synth_genome(genome_bp, "repeats", seed=7)
    fa = os.path.join(work, "ref.fa")
    write_fasta(fa, g, f"synth_repeats_{genome_bp // 1_000_000}M")
    prefix = os.path.join(work, "ref")
    t0 = time.perf_counter()
    cli("index", fa, "-p", prefix, "-s", 8)
    log(f"setup index_build_s={time.perf_counter() - t0:.1f} "
        f"genome_bp={genome_bp}")
    return g, prefix


def one_card(work, genome_bp=GENOME_BP, se_n=SE_READS, se_batch=SE_BATCH,
             beam_n=BEAM_READS, pe_n=PE_PAIRS, pe_batch=PE_BATCH,
             cmp_n=CMP_READS, cmp_pairs=CMP_PAIRS, oracle_n=ORACLE_READS):
    import jax
    g, prefix = build_index(work, genome_bp)
    p = lambda name: os.path.join(work, name)          # noqa: E731

    # ---- single-end: pigeon path, retry, pooled beam flush ----------------
    reads = se_reads(g, se_n, SE_LEN)
    names = [f"se{j}" for j in range(se_n)]
    write_fastq(p("se.fq"), names, reads)
    t0 = time.perf_counter()
    with counting_escalations() as esc:
        cli("align", prefix, p("se.fq"), "--batch", se_batch,
            "--metrics", p("se.json"), "-f", p("se.sam"))
    m, frac = batch_stats(p("se.json"))
    log(f"align SE reads={se_n} batch={se_batch} "
        f"wall_s={time.perf_counter() - t0:.1f} "
        f"mapped_frac={m['mapped_frac']} fallback_frac={frac['fallback']} "
        f"retry_frac={frac['retry']} trunc_frac={frac['trunc']} "
        f"retry_passes={esc['retry']} beam_flushes={esc['beam']}")
    if m["records_out"] != se_n or not esc["retry"] or not esc["beam"]:
        raise RuntimeError("SE run did not exercise the seg_phase retry and "
                           "the pooled beam flush")

    # ---- beam engine, ladder 8,64 -----------------------------------------
    write_fastq(p("beam.fq"), names[:beam_n], reads[:beam_n])
    t0 = time.perf_counter()
    cli("align", prefix, p("beam.fq"), "--engine", "beam", "--ladder", "8,64",
        "--metrics", p("beam.json"), "-f", p("beam.sam"))
    mb, _ = batch_stats(p("beam.json"))
    log(f"align beam reads={beam_n} ladder=8,64 "
        f"wall_s={time.perf_counter() - t0:.1f} "
        f"mapped_frac={mb['mapped_frac']} "
        f"overflow_reads={mb.get('beam_overflow_reads', 0)}")

    # ---- paired-end ---------------------------------------------------------
    r1, r2 = pe_reads(g, pe_n, PE_LEN)
    pnames = [f"pe{j}" for j in range(pe_n)]
    write_fastq(p("pe1.fq"), pnames, r1)
    write_fastq(p("pe2.fq"), pnames, r2)
    t0 = time.perf_counter()
    cli("align-pe", prefix, p("pe1.fq"), p("pe2.fq"), "--batch", pe_batch,
        "--metrics", p("pe.json"), "-f", p("pe.sam"))
    mp, _ = batch_stats(p("pe.json"))
    log(f"align PE pairs={pe_n} batch={pe_batch} "
        f"wall_s={time.perf_counter() - t0:.1f} "
        f"mapped_frac={mp['mapped_frac']}")
    if mp["records_out"] != 2 * pe_n:
        raise RuntimeError("PE run lost records")

    # ---- the same CLI path on the CPU backend ------------------------------
    # A batch shares its candidate pools and escalation capacity, so each
    # comparison gives both backends the same input file and batch.
    write_fastq(p("cmp.fq"), names[:cmp_n], reads[:cmp_n])
    write_fastq(p("cmp1.fq"), pnames[:cmp_pairs], r1[:cmp_pairs])
    write_fastq(p("cmp2.fq"), pnames[:cmp_pairs], r2[:cmp_pairs])
    runs = {
        "se": ("align", prefix, p("cmp.fq")),
        "beam": ("align", prefix, p("beam.fq"), "--engine", "beam",
                 "--ladder", "8,64"),
        "pe": ("align-pe", prefix, p("cmp1.fq"), p("cmp2.fq")),
    }
    for tag, args in runs.items():
        if tag != "beam":       # the beam phase's own output is compared
            cli(*args, "-f", p(f"cmp_{tag}_gpu.sam"))
        t0 = time.perf_counter()
        on_cpu(lambda: cli(*args, "-f", p(f"cmp_{tag}_cpu.sam")))
        log(f"cpu run {tag}: {time.perf_counter() - t0:.1f} s")
    compare("SE gpu vs cpu", sam_records(p("cmp_se_gpu.sam")),
            sam_records(p("cmp_se_cpu.sam")))
    compare("beam gpu vs cpu", sam_records(p("beam.sam")),
            sam_records(p("cmp_beam_cpu.sam")))
    compare("PE gpu vs cpu", sam_records(p("cmp_pe_gpu.sam")),
            sam_records(p("cmp_pe_cpu.sam")))

    # ---- oracle sample, docs/PARITY.md contract ------------------------------
    oracle_check(prefix, reads[:cmp_n], names[:cmp_n],
                 sam_records(p("cmp_se_gpu.sam")), oracle_n, m["config"])

    # ---- memory ---------------------------------------------------------------
    memory_report(prefix, reads[:se_batch], beam_n)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"peak_bytes_in_use={peak}")


def oracle_check(prefix, reads, names, cli_lines, n, config):
    """Oracle SAM == device SAM for every sampled read the contract covers:
    reads with a beam overflow or a capped repeat enumeration are the
    documented deviations (docs/PARITY.md) and are counted, not compared."""
    from hsa_tpu import refpack
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.fmcore import FMIndex
    from hsa_tpu.pipeline import Aligner, ReadBatch, oracle_align
    opt = AlnOpt(**config["opt"])
    al = Aligner(prefix, opt)
    rb = ReadBatch.from_reads(reads)
    quals = ["I" * len(r) for r in reads]
    # the library path on the CLI's input: the same lines, plus the flags
    occ, trunc, c2x = al._align_occ(al._align_device(rb))
    ld, hd = al.last_overflow
    lines, _ = al._resolve_occ(rb, names, quals, occ, trunc, c2x, emit="sam")
    compare("library vs cli", lines, cli_lines)
    t0 = time.perf_counter()
    text = al.text
    fms = (FMIndex.build(text, sa_intv=al.di.sa_intv, keep_sa=False,
                         sa=refpack.suffix_array(text)),
           FMIndex.build(text[::-1].copy(), sa_intv=al.di.sa_intv,
                         keep_sa=False,
                         sa=refpack.suffix_array(text[::-1].copy())))
    log(f"oracle index build: {time.perf_counter() - t0:.1f} s")
    flagged = [bool(trunc[j] or ld[j] or hd[j]) for j in range(n)]
    t0 = time.perf_counter()
    bad = []
    for j in range(n):
        if flagged[j]:
            continue
        rec = oracle_align(text, al.meta, [reads[j]], [names[j]],
                           [quals[j]], opt, read_offset=j, fms=fms)[0]
        if rec.to_sam() != lines[j]:
            bad.append((j, rec.to_sam()))
    log(f"oracle: {n} reads sampled, {n - sum(flagged)} compared in "
        f"{time.perf_counter() - t0:.1f} s, {sum(flagged)} documented "
        f"deviations (capped repeat / beam overflow), mismatch={len(bad)}")
    if bad:
        j, want = bad[0]
        log(f"  device {lines[j][:200]}\n[smoke]   oracle {want[:200]}")
        raise RuntimeError(f"{len(bad)} reads differ from the oracle")


def memory_report(prefix, reads, beam_n):
    """compiled.memory_analysis() of the pigeon step and the beam ladder at
    the shapes the runs above used."""
    import jax
    import jax.numpy as jnp
    from hsa_tpu import refpack
    from hsa_tpu.pipeline import Aligner, ReadBatch
    from hsa_tpu.search import pigeon as pg
    from hsa_tpu.search.adaptive import AdaptiveBeam
    al = Aligner(prefix)
    rb = ReadBatch.from_reads(reads)
    n_seg, _ = al._pigeon_split(rb)
    md = np.asarray([al.opt.diff_budget(int(L)) for L in rb.lens], np.int32)
    K = al._kmer_k
    buf, shape = refpack.pigeon_pack(rb.mat, rb.lens, md, n_seg, K,
                                     pg.auto_anchor_tail(int(al.di.n), K))
    memory_line(f"pigeon_step lanes={2 * len(rb)}",
                al._pigeon_search_fn(n_seg)[2](buf, shape))
    lanes = 2 * beam_n
    Lmax = rb.mat.shape[1]
    sds = jax.ShapeDtypeStruct
    ab = AdaptiveBeam(al.dev, al.opt, ladder=(8, 64), max_hits=32)
    memory_line(f"beam_ladder lanes={lanes} ladder=8,64",
                ab.lower(sds((lanes, Lmax), jnp.uint8), sds((lanes,), jnp.int32),
                         sds((lanes, Lmax), jnp.int32),
                         sds((lanes,), jnp.int32)))


# ------------------------------------------------------------- four cards --
def four_cards(work, genome_bp=GENOME_BP, n=SHARD_READS):
    """Sharded beam, pigeon and locate on (1 x 4) and (4 x 1) meshes ==
    the single-card results on device 0."""
    import jax
    import jax.numpy as jnp
    from hsa_tpu import alphabet
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.dist.mesh import ShardedIndex, make_mesh
    from hsa_tpu.index.layout import DeviceIndex
    from hsa_tpu.search import fm, pigeon as pg
    from hsa_tpu.search.adaptive import finalize_any
    from hsa_tpu.search.beam import beam_search
    from hsa_tpu.search.jitcache import jit_over_idx
    from hsa_tpu.search.widths import cal_width_device
    g, prefix = build_index(work, genome_bp)
    di = DeviceIndex.load(prefix + ".hsa/index.npz")
    reads = [r for r in se_reads(g, n, SE_LEN) if len(r) == SE_LEN]
    reads = reads[:len(reads) // 4 * 4]
    both = reads + [alphabet.revcomp(r) for r in reads]
    B = len(both)
    fwd = jnp.asarray(np.stack(both).astype(np.uint8))
    lens = jnp.full(B, SE_LEN, jnp.int32)
    opt = AlnOpt(max_diff=2, max_gapo=1)
    # ungapped pigeon: the gapped pool-2 has a per-data-slice capacity, so
    # its overflow would depend on how lanes are split over the mesh
    popt = AlnOpt(max_diff=2, max_gapo=0)
    md = jnp.full(B, 2, jnp.int32)
    W, H, n_seg, CC = 64, 32, 3, 16
    batch = pg.pack_pigeon_batch(both, n_seg=n_seg, seed_len=opt.seed_len)
    # every lane's CC slots fit the pool, so no lane's result depends on
    # how lanes are split over the data axis
    pool_mult = CC

    with jax.default_device(jax.devices()[0]):
        idx0 = di.as_jax()
        trows = jnp.asarray(pg.pack_text_rows(g))
        D = jit_over_idx(idx0, cal_width_device)(fwd, lens)
        ref_beam = jit_over_idx(idx0, lambda ix, f, ln, d, m: beam_search(
            ix, f, ln, d, m, opt, beam_width=W, max_hits=H))(
                fwd, lens, D, md)
        ranks = jnp.where(ref_beam.hkey[0] < 0x7FFF0000, ref_beam.hit_k[0],
                          jnp.uint32(0))
        ref_pos = jit_over_idx(idx0, fm.locate)(ranks)
        ref_pig = jit_over_idx(idx0, lambda ix, tr, bt, m: pg.pigeon_search(
            ix, tr, bt["segs_rev"], bt["seg_lens"], bt["seg_off"], bt["rw"],
            bt["nmask"], bt["vmask"], bt["seedmask"], bt["lens"], m, popt,
            n_seg=n_seg, cand_cap=CC, pool=pool_mult * B))(
                trows, {k: jnp.asarray(v) for k, v in batch.items()}, md)
    ref_hits = finalize_any(ref_beam, opt.s_mm)
    ref_occ = pg.pigeon_occ_arrays(pg.fetch_result(ref_pig), B // 2, popt, CC)
    log(f"single card: {B} lanes, "
        f"{int(np.asarray(ref_hits.hit_valid).any(axis=1).sum())} with hits, "
        f"{len(ref_occ[0]['pos'])} pigeon occurrences")

    for n_data, n_shard in ((1, 4), (4, 1)):
        sidx = ShardedIndex(di, make_mesh(n_data, n_shard))
        t0 = time.perf_counter()
        D2 = sidx.width_fn()(fwd, lens)
        res = sidx.beam_fn(opt, beam_width=W, max_hits=H)(fwd, lens, D2, md)
        pos = sidx.locate_fn()(ranks)
        pig = sidx.pigeon_fn(popt, n_seg, trows, cand_cap=CC,
                             pool_mult=pool_mult)(batch, md)
        jax.block_until_ready((res, pos, pig))
        hits = finalize_any(res, opt.s_mm)
        occ = pg.pigeon_occ_arrays(pg.fetch_result(pig), B // 2, popt, CC)
        for a, b in zip(hits, ref_hits):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(pos), np.asarray(ref_pos))
        for k in ref_occ[0]:
            np.testing.assert_array_equal(occ[0][k], ref_occ[0][k],
                                          err_msg=k)
        np.testing.assert_array_equal(occ[1], ref_occ[1])
        np.testing.assert_array_equal(occ[2], ref_occ[2])
        log(f"mesh data={n_data} shard={n_shard}: beam hit sets, locate "
            f"positions and pigeon occurrences (pos, strand, score) equal "
            f"device 0 ({time.perf_counter() - t0:.1f} s incl. compile)")


# ------------------------------------------------------------------ main --
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded-index check on four cards")
    a = ap.parse_args(argv)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX finds no GPU (platform "
                 f"{devs[0].platform!r})")
    need = 4 if a.four_cards else 1
    if len(devs) < need:
        sys.exit(f"chip_smoke: needs {need} GPUs, JAX finds {len(devs)}")
    from hsa_tpu import refpack
    from hsa_tpu.cache import ROOT, enable_compile_cache
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"device_kind={devs[0].device_kind} count={len(devs)}")
    print(smi, flush=True)          # name, power limit: one line per card
    log(f"compile cache: {enable_compile_cache()}")
    if not refpack.available():
        sys.exit("chip_smoke: the native refpack library did not load")
    log(f"refpack: {refpack.so_path()}")
    work = os.path.join(ROOT, "smoke")
    if a.four_cards:
        four_cards(work)
    else:
        one_card(work)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
