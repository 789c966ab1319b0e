"""Command-line interface mirroring the reference UX (lineage: ``main.c``).

Subcommands: ``index``, ``aln``, ``samse``, ``align`` (fused aln+samse).
The ``aln`` -> ``.sai.npz`` -> ``samse`` split mirrors the reference's
two-phase resumable design (SURVEY.md §5 checkpoint/resume row).

Usage:
    python -m hsa_tpu.cli index ref.fa [-p prefix] [-s sa_intv]
    python -m hsa_tpu.cli aln prefix reads.fq -f out.sai.npz [search opts]
    python -m hsa_tpu.cli samse prefix out.sai.npz reads.fq [-f out.sam]
    python -m hsa_tpu.cli align prefix reads.fq [-f out.sam] [search opts]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import alphabet
from .config import AlnOpt, SamseOpt


def _add_search_opts(p):
    p.add_argument("-n", dest="n", default=None,
                   help="max #diff (int) or missing-prob (float, default 0.04)")
    p.add_argument("-o", dest="max_gapo", type=int, default=1, help="max gap opens")
    p.add_argument("-e", dest="max_gape", type=int, default=6, help="max gap extensions")
    p.add_argument("-l", dest="seed_len", type=int, default=32, help="seed length")
    p.add_argument("-k", dest="max_seed_diff", type=int, default=2, help="max seed diffs")
    p.add_argument("-M", dest="s_mm", type=int, default=3, help="mismatch penalty")
    p.add_argument("-O", dest="s_gapo", type=int, default=11, help="gap open penalty")
    p.add_argument("-E", dest="s_gape", type=int, default=4, help="gap extension penalty")
    p.add_argument("-q", dest="trim_qual", type=int, default=0,
                   help="3' quality trimming threshold (0 = off)")
    p.add_argument("-W", dest="beam_width", type=int, default=None,
                   help="beam width (frontier capacity per read)")
    p.add_argument("--ladder", default=None,
                   help="adaptive beam widths, e.g. 8,64 (overrides -W)")
    p.add_argument("--batch", type=int, default=16384,
                   help="reads per device batch")


def _opt_from_args(a) -> AlnOpt:
    opt = AlnOpt(max_gapo=a.max_gapo, max_gape=a.max_gape, seed_len=a.seed_len,
                 max_seed_diff=a.max_seed_diff, s_mm=a.s_mm, s_gapo=a.s_gapo,
                 s_gape=a.s_gape, trim_qual=getattr(a, "trim_qual", 0))
    if a.n is not None:
        try:
            opt.max_diff = int(a.n)
        except ValueError:
            opt.max_diff = -1
            opt.fnr = float(a.n)
    return opt


def _apply_trim(reads, quals, trim_qual):
    if trim_qual < 1:
        return reads, quals
    from .io.fastx import trim_read_length
    out_r, out_q = [], []
    for r, q in zip(reads, quals):
        L = trim_read_length(q, trim_qual)
        out_r.append(r[:L])
        out_q.append(q[:L] if q and q != "*" else q)
    return out_r, out_q


def _load_reads(path, limit=None):
    from .io.fastx import read_fastq, read_fasta
    names, reads, quals = [], [], []
    it = read_fastq(path) if any(path.endswith(s) for s in
                                 (".fq", ".fastq", ".fq.gz", ".fastq.gz")) else None
    if it is not None:
        for name, seq, qual in it:
            names.append(name); reads.append(alphabet.encode(seq)); quals.append(qual)
            if limit and len(reads) >= limit:
                break
    else:
        for name, seq in read_fasta(path):
            names.append(name); reads.append(alphabet.encode(seq)); quals.append("*")
            if limit and len(reads) >= limit:
                break
    return names, reads, quals


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu index")
    p.add_argument("fasta")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("-s", "--sa-intv", type=int, default=32)
    a = p.parse_args(argv)
    from .pipeline import build_index
    out = build_index(a.fasta, a.prefix or a.fasta, sa_intv=a.sa_intv)
    print(f"[hsa-tpu] index written to {out}", file=sys.stderr)


def _iter_batches(names, reads, quals, batch):
    for s in range(0, len(reads), batch):
        yield s, names[s:s + batch], reads[s:s + batch], quals[s:s + batch]


def _prefetch(gen, depth: int = 2):
    """Run a batch generator on a reader thread, ``depth`` items ahead.

    The stream pipelines device work against host resolution, but the
    GENERATOR itself (gz inflate + FASTQ parse + name/qual string
    materialization, ~100-150 ms per 16K batch) otherwise runs serially
    inside the stream's fill loop on the main thread.
    """
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(DONE)
        except BaseException as e:     # surface reader errors in-loop
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


_OCC_FIELDS = ("rid", "pos", "strand", "score", "nmm", "ngapo", "ngape")


def cmd_aln(argv):
    """Search phase of the two-phase flow.

    ``.sai.npz`` v2 stores POSITION-RECORDS (located, deduped occurrence
    arrays + truncation info) plus the full search options — samse/sampe
    re-apply the same trim/budgets and skip locate entirely, so the
    two-phase flow runs at fused-``align`` speed with identical records.
    The lineage stores (k,l) SA intervals instead; registered as format
    deviation (docs/PARITY.md .sai note — SAM output is unaffected).
    """
    p = argparse.ArgumentParser(prog="hsa-tpu aln")
    p.add_argument("prefix")
    p.add_argument("reads")
    p.add_argument("-f", "--out", required=True, help="output .sai.npz")
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its part shards")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "beam", "pigeon"])
    _add_search_opts(p)
    a = p.parse_args(argv)
    import json
    import os
    from .pipeline import Aligner
    from .metrics import RunMetrics
    met = RunMetrics()
    opt = _opt_from_args(a)
    met.config = dict(cmd="aln", reads=a.reads, batch=a.batch,
                      beam_width=a.beam_width, ladder=a.ladder,
                      engine=a.engine, opt=opt.to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, ladder=ladder, engine=a.engine)
    args_key = f"aln|{a.reads}|{a.batch}|{a.beam_width}|{a.n}|{a.engine}"
    done = _load_manifest(a.out, args_key) if a.resume else 0
    if done:
        met.log(f"resuming at read {done}")
    parts_dir = a.out + ".parts"
    os.makedirs(parts_dir, exist_ok=True)
    # streaming: search + readback per batch, one part shard per batch —
    # host RSS stays flat regardless of input size; the final .sai.npz is
    # a straight concatenation of the shards
    n_reads = 0
    part_files = []
    for s, bn, br, bq in _stream_batches(a.reads, a.batch, opt.trim_qual):
        n_reads = s + len(br)
        pf = os.path.join(parts_dir, f"part_{s:012d}.npz")
        part_files.append(pf)
        if n_reads <= done and os.path.exists(pf):
            met.count("reads_in", len(br))
            continue
        with met.timer("search"):
            h = al._align_device(br, beam_width=a.beam_width)
            occ, trunc, c2x = al._align_occ(h, beam_width=a.beam_width)
        ld, hd = al.last_overflow
        met.count("beam_overflow_reads", int((np.asarray(ld) > 0).sum()))
        met.count("reads_in", len(br))
        np.savez(pf, nreads=np.int64(len(br)),
                 trunc=np.asarray(trunc, bool),
                 c2x=np.asarray(c2x, np.int64),
                 **{k: occ[k] for k in _OCC_FIELDS})
        _save_manifest(a.out, args_key, n_reads, -1)
        met.log(f"aln {n_reads} reads")
    # finalize: merge shards (in order; rid globalized) into the .sai.npz
    merged = {k: [] for k in _OCC_FIELDS + ("trunc", "c2x")}
    start = 0
    for pf in part_files:
        z = np.load(pf)
        for k in merged:
            v = z[k]
            if k == "rid":
                v = v + start
            merged[k].append(v)
        start += int(z["nreads"])
    np.savez_compressed(
        a.out, version=np.int64(2), batch=np.int64(a.batch),
        nreads=np.int64(start), opt=json.dumps(opt.to_dict()),
        **{k: (np.concatenate(v) if v else np.zeros(0, np.int64))
           for k, v in merged.items()})
    for pf in part_files:
        os.remove(pf)
    os.rmdir(parts_dir)
    met.dump(a.metrics)


def _sai_meta(path):
    """(AlnOpt, batch_size, nreads) stored in a v2 .sai.npz."""
    import json
    from .config import AlnOpt
    z = np.load(path)
    if "version" not in z or int(z["version"]) != 2:
        raise SystemExit(f"error: {path} is not a v2 .sai.npz "
                         "(re-run `hsa-tpu aln`)")
    opt = AlnOpt(**json.loads(str(z["opt"])))
    return opt, int(z["batch"]), int(z["nreads"])


def _sai_stream(path):
    """Yield (start, occ dict (batch-local rid), trunc, c2x) per batch.

    The v2 payload is position-records: occurrence arrays are already
    located and deduped, so resolution needs no device locate pass.
    """
    z = np.load(path)
    if "version" not in z or int(z["version"]) != 2:
        raise SystemExit(f"error: {path} is not a v2 .sai.npz")
    bsz = max(int(z["batch"]), 1)
    nreads = int(z["nreads"])
    fields = {k: z[k] for k in _OCC_FIELDS}
    rid = fields["rid"]
    assert (rid[1:] >= rid[:-1]).all(), "corrupt .sai stream (rid order)"
    trunc = z["trunc"]
    c2x = z["c2x"]
    assert len(trunc) == nreads and len(c2x) == nreads, "corrupt .sai"
    for s in range(0, nreads, bsz):
        e = min(s + bsz, nreads)
        lo, hi = np.searchsorted(rid, [s, e])
        occ = {k: (v[lo:hi] - s if k == "rid" else v[lo:hi])
               for k, v in fields.items()}
        yield s, occ, trunc[s:e], c2x[s:e]


def cmd_samse(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu samse")
    p.add_argument("prefix")
    p.add_argument("sai")
    p.add_argument("reads")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("-n", dest="n_multi", type=int, default=3)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run (requires -f)")
    a = p.parse_args(argv)
    from .pipeline import Aligner
    from .io.sam import sam_header
    from .resolve.samse import resolve_from_occ_arrays
    from .metrics import RunMetrics
    met = RunMetrics()
    # the .sai carries the aln-time options (lineage gap_opt_t in the
    # .sai header): trim and budgets are re-applied here so resolution
    # sees exactly the reads the search saw
    opt, bsz, _n_sai = _sai_meta(a.sai)
    met.config = dict(cmd="samse", sai=a.sai, reads=a.reads,
                      opt=opt.to_dict())
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt)
    args_key = f"samse|{a.sai}|{a.reads}|{bsz}"
    done = _load_manifest(a.out, args_key) if a.resume else 0
    mode = "a" if (a.resume and done) else "w"
    out = open(a.out, mode) if a.out else sys.stdout
    if not done:
        out.write(sam_header(al.meta, "samse"))
    else:
        met.log(f"resuming at read {done}")
    n = 0
    for (s, bn, br, bq), (s2, occ, trunc, c2x) in _zip_lockstep(
            _stream_batches(a.reads, bsz, opt.trim_qual),
            _sai_stream(a.sai)):
        assert s == s2 and len(br) == len(trunc), \
            "read file does not match .sai"
        n = s + len(br)
        if n <= done:
            met.count("reads_in", len(br))
            continue
        with met.timer("resolve"):
            lines, flags = resolve_from_occ_arrays(
                al.text, al.meta, br, bn, bq, occ, trunc.tolist(), opt,
                SamseOpt(n_multi=a.n_multi), read_offset=s, emit="sam",
                c2_extra=c2x)
        out.write("\n".join(lines) + "\n")
        met.count("reads_in", len(br))
        met.count("records_out", len(lines))
        met.count("reads_mapped", sum(1 for f in flags if not f & 4))
        _save_manifest(a.out, args_key, n, -1)
    out.flush()
    print(f"[hsa-tpu samse] {n} reads", file=sys.stderr)
    if a.out:
        out.close()
    met.dump(a.metrics)


def _zip_lockstep(*iters):
    """zip() that FAILS when the streams exhaust unevenly.

    Plain zip() silently drops whole trailing batches when mate/.sai
    files differ by a multiple of the batch size — the per-batch length
    asserts never fire.  Streaming commands must use this instead.
    """
    from itertools import zip_longest
    sentinel = object()
    for tup in zip_longest(*iters, fillvalue=sentinel):
        assert sentinel not in tup, \
            "input streams exhausted unevenly (mate/.sai files do not match)"
        yield tup


def _manifest_path(out):
    return out + ".manifest.json"


def _load_manifest(out, args_key):
    """Completed-batch count if a matching resume manifest exists, else 0.

    Batch-granular restart (SURVEY.md §5 failure-recovery row): the input
    stream is resumable by read ordinal, so a crashed run resumes at the
    first incomplete batch.
    """
    import json, os
    if not out or not os.path.exists(_manifest_path(out)):
        return 0
    try:
        with open(_manifest_path(out)) as fh:
            m = json.load(fh)
        if m.get("args_key") == args_key:
            return int(m.get("completed_reads", 0))
    except Exception:
        pass
    return 0


def _save_manifest(out, args_key, completed_reads, total):
    import json
    if not out:
        return
    with open(_manifest_path(out), "w") as fh:
        json.dump(dict(args_key=args_key, completed_reads=completed_reads,
                       total_reads=total), fh)


def _stream_batches(path, batch, trim_qual=0):
    """Yield (start_ordinal, names, reads, quals) batches with bounded RSS.

    FASTQ goes through the native mmap batcher (no per-read Python objects
    until a batch materializes); FASTA falls back to the simple loader.
    """
    if any(path.endswith(s) for s in (".fq", ".fastq", ".fq.gz", ".fastq.gz")):
        from .io.fastq_fast import FastqBatcher
        from .pipeline import ReadBatch
        s = 0
        for names, codes, lens, quals in FastqBatcher(path, batch=batch):
            lens = np.asarray(lens, np.int32)
            if trim_qual >= 1:
                from .io.fastx import trim_read_length
                tl = np.fromiter((trim_read_length(q, trim_qual)
                                  for q in quals), np.int32, len(quals))
                lens = np.minimum(lens, tl)
                quals = [q[:l] if q and q != "*" else q
                         for q, l in zip(quals, lens.tolist())]
            # trim the [B, max_len=512] parser matrix to the batch's
            # actual max read length: the packed-word count (and with it
            # the whole device program width) follows the matrix width,
            # so a 100bp batch in a 512-wide matrix would run a 4x-wider
            # search
            Lmax = int(lens.max()) if len(lens) else 1
            yield s, names, ReadBatch(codes[:, :max(Lmax, 1)], lens), quals
            s += len(names)
    else:
        names, reads, quals = _load_reads(path)
        reads, quals = _apply_trim(reads, quals, trim_qual)
        for s, bn, br, bq in _iter_batches(names, reads, quals, batch):
            yield s, bn, br, bq


def cmd_align(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu align")
    p.add_argument("prefix")
    p.add_argument("reads")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("--n-multi", type=int, default=3)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace of one batch to this dir")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its .manifest.json")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "pigeon", "beam"),
                   help="search engine routing (default auto)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    from .pipeline import Aligner
    from .io.sam import sam_header
    from .metrics import RunMetrics
    met = RunMetrics()
    met.config = dict(cmd="align", reads=a.reads, batch=a.batch,
                      beam_width=a.beam_width, engine=a.engine,
                      opt=_opt_from_args(a).to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, _opt_from_args(a), ladder=ladder,
                     engine=a.engine)
    args_key = f"align|{a.reads}|{a.batch}|{a.beam_width}|{a.n}"
    done = _load_manifest(a.out, args_key) if a.resume else 0
    mode = "a" if (a.resume and done) else "w"
    out = open(a.out, mode) if a.out else sys.stdout
    if not done:
        out.write(sam_header(al.meta, "align"))
    if done:
        met.log(f"resuming at read {done}")
    # Streaming single-phase flow: each batch is searched, resolved, and
    # written in input order — host RSS and device HBM stay bounded
    # regardless of input size.  The default path is PIPELINED
    # (Aligner.align_stream): batch n+1's pack/search/fetch overlaps
    # batch n's host resolution.  --profile falls back to the sequential
    # loop so the trace captures one isolated batch.
    total = 0
    if a.profile:
        profiled = False
        for s, bn, br, bq in _stream_batches(a.reads, a.batch,
                                             getattr(a, "trim_qual", 0)):
            total = s + len(br)
            if total <= done:
                continue
            if not profiled:
                import jax
                profiled = True
                with jax.profiler.trace(a.profile):
                    recs = al.align(br, bn, bq, read_offset=s,
                                    beam_width=a.beam_width,
                                    sopt=SamseOpt(n_multi=a.n_multi))
                met.log(f"profiler trace written to {a.profile}")
            else:
                with met.timer("align"):
                    recs = al.align(br, bn, bq, read_offset=s,
                                    beam_width=a.beam_width,
                                    sopt=SamseOpt(n_multi=a.n_multi))
            met.note_batch(len(br), recs, al.last_overflow, aligner=al)
            with met.timer("write"):
                for r in recs:
                    out.write(r.to_sam() + "\n")
                out.flush()
            _save_manifest(a.out, args_key, total, -1)
            met.log(f"align {total} reads")
    else:
        def todo():
            for s, bn, br, bq in _stream_batches(a.reads, a.batch,
                                                 getattr(a, "trim_qual", 0)):
                if s + len(br) > done:
                    yield s, bn, br, bq
        stream = iter(al.align_stream(_prefetch(todo()),
                                      beam_width=a.beam_width,
                                      sopt=SamseOpt(n_multi=a.n_multi),
                                      emit="sam"))
        while True:
            with met.timer("align"):   # wall per batch incl. overlap wait
                item = next(stream, None)
            if item is None:
                break
            s, (lines, flags) = item
            total = s + len(lines)
            met.note_batch(len(lines), lines, al.last_overflow, flags=flags,
                           aligner=al)
            with met.timer("write"):
                out.write("\n".join(lines))
                out.write("\n")
                out.flush()
            _save_manifest(a.out, args_key, total, -1)
            met.log(f"align {total} reads")
    if a.out:
        out.close()
    s = met.dump(a.metrics)
    met.log(f"done: {s.get('reads_mapped', 0)}/{s.get('reads_in', 0)} mapped, "
            f"{s.get('beam_overflow_reads', 0)} overflow reads")


def cmd_sampe(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu sampe")
    p.add_argument("prefix")
    p.add_argument("sai1")
    p.add_argument("sai2")
    p.add_argument("reads1")
    p.add_argument("reads2")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("-a", dest="max_isize", type=int, default=500)
    p.add_argument("-n", dest="n_multi", type=int, default=3)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run (requires -f)")
    a = p.parse_args(argv)
    from .pipeline import Aligner
    from .io.sam import sam_header
    from .config import PEOpt
    from .resolve.sampe import resolve_pe_from_occ_arrays
    from .metrics import RunMetrics
    met = RunMetrics()
    # both .sai files carry the aln-time options; they must agree (the
    # lineage reads gap_opt_t from each .sai header the same way)
    opt, bsz, _n1 = _sai_meta(a.sai1)
    opt2, bsz2, _n2 = _sai_meta(a.sai2)
    assert bsz == bsz2, ".sai batch sizes differ"
    assert opt.to_dict() == opt2.to_dict(), ".sai search options differ"
    met.config = dict(cmd="sampe", sai1=a.sai1, sai2=a.sai2,
                      opt=opt.to_dict())
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt)
    peopt = PEOpt(max_isize=a.max_isize, n_multi=a.n_multi)
    args_key = f"sampe|{a.sai1}|{a.sai2}|{a.reads1}|{a.reads2}|{bsz}"
    done = _load_manifest(a.out, args_key) if a.resume else 0
    mode = "a" if (a.resume and done) else "w"
    out = open(a.out, mode) if a.out else sys.stdout
    if not done:
        out.write(sam_header(al.meta, "sampe"))
    else:
        met.log(f"resuming at pair {done}")
    n = 0
    # streaming: both mates' read + .sai streams advance in lockstep;
    # insert-size inference is batch-local (matches align-pe)
    for (s, n1, r1, q1), (s2, n2, r2, q2), (s3, occ1, tr1, cx1), \
            (s4, occ2, tr2, cx2) \
            in _zip_lockstep(_stream_batches(a.reads1, bsz, opt.trim_qual),
                             _stream_batches(a.reads2, bsz, opt.trim_qual),
                             _sai_stream(a.sai1), _sai_stream(a.sai2)):
        assert s == s2 == s3 == s4 and len(r1) == len(r2) == len(tr1), \
            "mate/sai files do not match"
        n = s + len(r1)
        if n <= done:
            met.count("reads_in", 2 * len(r1))
            continue
        with met.timer("resolve"):
            # ONE flat occ dict over both ends (end 2 rids shifted by B):
            # the two .sai blocks are each rid-sorted, so concatenation
            # is already in canonical (rid, score, strand, pos) order
            B = len(r1)
            occ = {k: np.concatenate([occ1[k],
                                      occ2[k] + B if k == "rid"
                                      else occ2[k]])
                   for k in occ1}
            lines, _flags = resolve_pe_from_occ_arrays(
                al.text, al.meta, r1, r2, n1, q1, q2, occ, opt, peopt,
                read_offset=s,
                trunc=np.concatenate([tr1, tr2]).astype(bool),
                c2x=np.concatenate([cx1, cx2]), emit="sam")
        out.write("\n".join(lines))
        out.write("\n")
        met.count("reads_in", 2 * len(r1))
        met.count("records_out", len(lines))
        _save_manifest(a.out, args_key, n, -1)
    out.flush()
    print(f"[hsa-tpu sampe] {n} pairs", file=sys.stderr)
    if a.out:
        out.close()
    met.dump(a.metrics)


def cmd_align_pe(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu align-pe")
    p.add_argument("prefix")
    p.add_argument("reads1")
    p.add_argument("reads2")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("-a", dest="max_isize", type=int, default=500)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its .manifest.json")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "pigeon", "beam"),
                   help="search engine routing (default auto)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    from .pipeline import Aligner
    from .io.sam import sam_header
    from .config import PEOpt
    from .metrics import RunMetrics
    met = RunMetrics()
    met.config = dict(cmd="align-pe", reads1=a.reads1, reads2=a.reads2,
                      batch=a.batch, beam_width=a.beam_width,
                      engine=a.engine, opt=_opt_from_args(a).to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, _opt_from_args(a), ladder=ladder,
                     engine=a.engine)
    args_key = f"align-pe|{a.reads1}|{a.reads2}|{a.batch}|{a.beam_width}|{a.n}"
    done = _load_manifest(a.out, args_key) if a.resume else 0
    mode = "a" if (a.resume and done) else "w"
    out = open(a.out, mode) if a.out else sys.stdout
    if not done:
        out.write(sam_header(al.meta, "align-pe"))
    else:
        met.log(f"resuming at pair {done}")
    peopt = PEOpt(max_isize=a.max_isize)
    # streaming: both mates' FASTQ batches advance in lockstep; each pair
    # batch is searched (pigeon + beam fallback), resolved, and written
    # before the next starts — flat RSS regardless of input size
    total = 0
    trim = getattr(a, "trim_qual", 0)

    def todo():
        for (s, n1, r1, q1), (s2, n2, r2, q2) in _zip_lockstep(
                _stream_batches(a.reads1, a.batch, trim),
                _stream_batches(a.reads2, a.batch, trim)):
            assert s == s2 and len(r1) == len(r2), \
                "mate files differ in read count"
            if s + len(r1) > done:
                yield s, n1, r1, q1, r2, q2

    stream = iter(al.align_pe_stream(_prefetch(todo()),
                                     beam_width=a.beam_width,
                                     peopt=peopt, emit="sam"))
    while True:
        with met.timer("align"):   # wall per batch incl. overlap wait
            item = next(stream, None)
        if item is None:
            break
        s, (lines, flags) = item
        total = s + len(lines) // 2
        met.count("reads_in", len(lines))
        met.count("records_out", len(lines))
        met.count("reads_mapped", sum(1 for f in flags if not (f & 4)))
        with met.timer("write"):
            out.write("\n".join(lines))
            out.write("\n")
            out.flush()
        _save_manifest(a.out, args_key, total, -1)
        met.log(f"align-pe {total} pairs")
    if a.out:
        out.close()
    s_ = met.dump(a.metrics)
    met.log(f"done: {s_.get('reads_mapped', 0)}/{s_.get('reads_in', 0)} "
            "ends mapped")


COMMANDS = {"index": cmd_index, "aln": cmd_aln, "samse": cmd_samse,
            "sampe": cmd_sampe, "align": cmd_align, "align-pe": cmd_align_pe}


def _configure_jax(argv):
    """Apply ``--platform`` (sets ``jax_platforms``) and enable the
    persistent compile cache.  Must run before any jax computation."""
    if "--platform" in argv:
        i = argv.index("--platform")
        import jax
        jax.config.update("jax_platforms", argv[i + 1])
        del argv[i:i + 2]
    from .cache import enable_compile_cache
    enable_compile_cache()
    return argv


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: hsa-tpu {{{'|'.join(COMMANDS)}}} ...", file=sys.stderr)
        return 1
    argv = _configure_jax(argv)
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
