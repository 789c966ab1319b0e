"""Native refpack builder vs the numpy reference core."""

import numpy as np
import pytest

from hsa_tpu import refpack
from hsa_tpu.fmcore import FMIndex, suffix_array as np_suffix_array


def rand_text(n, seed):
    return np.random.RandomState(seed).randint(0, 4, size=n).astype(np.int8)


def test_native_library_builds():
    # g++ is in the image; the native path must actually be exercised in CI
    assert refpack.available()


def test_library_rebuilds_when_a_source_changes(tmp_path):
    """The library is keyed on its sources: an edited source gets a new
    path and a fresh build; unchanged sources reuse the built file."""
    import os
    import shutil
    src = tmp_path / "src"
    src.mkdir()
    for name in ("refpack.cpp", "sais.hpp", "Makefile"):
        shutil.copy(os.path.join(os.path.dirname(refpack.__file__), name),
                    src / name)
    out = str(tmp_path / "build")
    first = refpack.build_library(str(src), out)
    assert os.path.exists(first)
    assert refpack.so_path(str(src), out) == first
    mtime = os.path.getmtime(first)
    assert refpack.build_library(str(src), out) == first
    assert os.path.getmtime(first) == mtime          # not rebuilt
    with open(src / "refpack.cpp", "a") as fh:
        fh.write("\n// edited\n")
    second = refpack.so_path(str(src), out)
    assert second != first and not os.path.exists(second)
    assert refpack.build_library(str(src), out) == second
    assert os.path.exists(second)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (17, 2), (1000, 3), (100_000, 4)])
def test_sais_matches_numpy(n, seed):
    t = rand_text(n, seed)
    np.testing.assert_array_equal(refpack.suffix_array(t), np_suffix_array(t))


def test_sais_repetitive_text():
    t = np.tile(np.array([0, 1, 0, 0, 1, 2], dtype=np.int8), 5000)
    np.testing.assert_array_equal(refpack.suffix_array(t), np_suffix_array(t))


def test_sais_homopolymer():
    t = np.zeros(10_000, dtype=np.int8)
    sa = refpack.suffix_array(t)
    # suffixes of A^n + $ sort longest-last: SA = [n, n-1, ..., 0]
    np.testing.assert_array_equal(sa, np.arange(10_000, -1, -1))


def test_fused_build_matches_fmindex():
    t = rand_text(5000, 7)
    fm = FMIndex.build(t, sa_intv=16)
    sa, bwt, primary, marks, samples = refpack.build(t, sa_intv=16, want_sa=True)
    np.testing.assert_array_equal(sa, fm.sa)
    np.testing.assert_array_equal(bwt.astype(np.int8), fm.bwt)
    assert primary == fm.primary
    np.testing.assert_array_equal(marks.astype(bool), fm.marks)
    np.testing.assert_array_equal(samples, fm.samples)


def test_pack_unpack_roundtrip():
    t = rand_text(1001, 9).astype(np.uint8)
    packed = refpack.pack_2bit(t)
    assert packed.size == (1001 + 3) // 4
    np.testing.assert_array_equal(refpack.unpack_2bit(packed, 1001), t)


def test_int64_instantiation_matches_int32():
    # the >2^31 production path, exercised at small scale via the test hook
    for n, seed in [(1000, 1), (50_000, 2)]:
        t = rand_text(n, seed)
        np.testing.assert_array_equal(refpack.suffix_array_force64(t),
                                      refpack.suffix_array(t))


def test_native_pigeon_pack_matches_numpy():
    """rp_pigeon_pack buffer == numpy pack_pigeon_batch + pack_pigeon_upload."""
    import numpy as np
    import pytest
    from hsa_tpu import refpack
    import hsa_tpu.search.pigeon as pg
    if not refpack.available() or refpack.pigeon_pack(
            np.zeros((1, 12), np.uint8), np.ones(1, np.int32),
            np.ones(1, np.int32), 2, 0, 4) is None:
        pytest.skip("native lib unavailable")
    rs = np.random.RandomState(3)
    for K, tail, n_seg, Lmax in ((0, 6, 3, 60), (6, 4, 3, 73), (12, 5, 5, 150)):
        B = 37
        mat = rs.randint(0, 4, (B, Lmax)).astype(np.uint8)
        lens = rs.randint(max(Lmax - 9, n_seg * 2), Lmax + 1,
                          B).astype(np.int32)
        # sprinkle Ns (incl. inside anchors)
        for _ in range(25):
            mat[rs.randint(B), rs.randint(Lmax)] = 4
        md = rs.randint(0, n_seg, B).astype(np.int32)
        native = refpack.pigeon_pack(mat, lens, md, n_seg, K, tail)
        assert native is not None
        buf_n, shape_n = native
        # numpy reference: revcomp lanes + pack + fuse
        t = np.arange(Lmax)[None, :]
        Rf = np.where(t < lens[:, None], mat, 5).astype(np.uint8)
        cols = np.clip(lens[:, None] - 1 - t, 0, Lmax - 1)
        Rr = np.take_along_axis(Rf, cols, axis=1)
        Rr = np.where(Rr <= 3, 3 - Rr, Rr).astype(np.uint8)
        Rr = np.where(t < lens[:, None], Rr, 5).astype(np.uint8)
        both = (np.vstack([Rf, Rr]), np.concatenate([lens, lens]))
        batch = pg.pack_pigeon_batch(both, n_seg=n_seg, seed_len=32,
                                     kmer_k=K, anchor_tail=tail,
                                     device_masks=True)
        buf_p, shape_p = pg.pack_pigeon_upload(
            batch, np.concatenate([md, md]))
        assert shape_n == shape_p, (shape_n, shape_p)
        assert np.array_equal(buf_n, buf_p), \
            (K, np.nonzero(buf_n != buf_p)[0][:5])


def test_native_banded_global_matches_numpy():
    """rp_banded_global == cigar.banded_global_ref (cost, CIGAR, jend)."""
    import numpy as np
    import pytest
    from hsa_tpu import refpack
    from hsa_tpu.resolve.cigar import banded_global_ref
    if refpack.banded_global(np.zeros(4, np.uint8), np.zeros(5, np.uint8),
                             3, 11, 4, 2) is None:
        pytest.skip("native lib unavailable")
    rs = np.random.RandomState(7)
    for trial in range(120):
        L = rs.randint(5, 60)
        band = rs.randint(1, 7)
        # correlated read/ref so paths have real structure
        ref = rs.randint(0, 4, L + rs.randint(0, 8)).astype(np.int8)
        read = ref[:L].copy()
        for _ in range(rs.randint(0, 4)):
            read[rs.randint(L)] = rs.randint(0, 5)  # incl. N
        if rs.randint(2) and L > 12:
            cut = rs.randint(2, L - 2)
            g = rs.randint(1, 3)
            if rs.randint(2):
                read = np.concatenate([read[:cut], read[cut + g:]])
            else:
                read = np.concatenate([read[:cut],
                                       rs.randint(0, 4, g).astype(np.int8),
                                       read[cut:]])
        a = banded_global_ref(read, ref, 3, 11, 4, band)
        b = refpack.banded_global(read, ref, 3, 11, 4, band)
        assert a[0] == b[0] and a[2] == b[2], (trial, a, b)
        assert list(a[1]) == list(b[1]), (trial, a[1], b[1])


def test_banded_batch_fuzz_vs_python_twin():
    """Direct fuzz of rp_banded_batch vs banded_global + cigar_stats
    (ADVICE r4): CIGAR/MD/NM/glen/gap-bases identical, including an
    n > 512 case that exercises the 8-thread path."""
    from hsa_tpu import refpack
    from hsa_tpu.resolve.cigar import banded_global, cigar_stats, cigar_string
    if refpack._load() is None or not hasattr(refpack._load(),
                                              "rp_banded_batch"):
        import pytest
        pytest.skip("native librefpack not available")
    rs = np.random.RandomState(91)
    text = rs.randint(0, 4, 20000).astype(np.int8)
    for n_jobs in (37, 700):          # single-thread and threaded paths
        Lmax = 72
        reads = np.zeros((n_jobs, Lmax), np.uint8)
        r_off = np.arange(n_jobs, dtype=np.int64) * Lmax
        r_len = np.zeros(n_jobs, np.int32)
        g_off = np.zeros(n_jobs, np.int64)
        g_len = np.zeros(n_jobs, np.int32)
        bands = np.zeros(n_jobs, np.int32)
        for i in range(n_jobs):
            L = int(rs.randint(40, Lmax + 1))
            p = int(rs.randint(0, len(text) - L - 8))
            w = text[p:p + L].copy()
            # plant mismatches and a 0-2bp indel
            for _ in range(rs.randint(0, 3)):
                q = rs.randint(0, L)
                w[q] = (w[q] + rs.randint(1, 4)) % 4
            g = int(rs.randint(0, 3))
            if g and L - 2 * g > 10:
                if rs.rand() < 0.5:       # deletion from the read
                    w2 = np.delete(text[p:p + L + g].copy(),
                                   slice(L // 2, L // 2 + g))
                    rd = w2[:L - g] if len(w2) >= L - g else w2
                    L = len(rd)
                else:                     # insertion into the read
                    ins = rs.randint(0, 4, g).astype(np.int8)
                    rd = np.concatenate([w[:L // 2], ins, w[L // 2:]])[:L]
                glen_w = L + g
            else:
                rd = w
                glen_w = L
                g = 0
            glen_w = min(glen_w, len(text) - p)
            reads[i, :len(rd)] = rd
            r_len[i] = len(rd)
            g_off[i] = p
            g_len[i] = glen_w
            bands[i] = g + 1
        out = refpack.banded_batch(reads, r_off, r_len, text, g_off,
                                   g_len, 3, 11, 4, bands)
        assert out is not None
        cigs, mds, nm, glen, gapb = out
        # spot-check ALL jobs of the small case, a sample of the big one
        check = range(n_jobs) if n_jobs < 100 else rs.choice(
            n_jobs, 60, replace=False)
        for i in check:
            rd = reads[i, :r_len[i]].astype(np.int8)
            rf = text[g_off[i]:g_off[i] + g_len[i]]
            _, cg, je = banded_global(rd, rf, 3, 11, 4, band=int(bands[i]))
            nm2, md2 = cigar_stats(cg, rd, rf)
            assert cigs[i] == cigar_string(cg), i
            assert mds[i] == md2, i
            assert nm[i] == nm2, i
            assert glen[i] == je, i
            assert gapb[i] == sum(ln for op, ln in cg if op in "ID"), i


def test_glocal_batch_matches_fit_in_window():
    """rp_glocal_batch is an exact twin of resolve.sampe.fit_in_window:
    same cost, start, and op sequence on randomized rescue-style jobs
    (incl. mismatch-heavy and indel reads), plus an n > 64 case for the
    threaded path."""
    from hsa_tpu import refpack
    from hsa_tpu.resolve.sampe import fit_in_window
    lib = refpack._load()
    if lib is None or not hasattr(lib, "rp_glocal_batch"):
        import pytest
        pytest.skip("native librefpack not available")
    rs = np.random.RandomState(123)
    text = rs.randint(0, 4, 30000).astype(np.int8)
    for n_jobs in (9, 100):
        Lmax = 60
        rbuf = np.zeros((n_jobs, Lmax), np.uint8)
        r_off = np.arange(n_jobs, dtype=np.int64) * Lmax
        r_len = np.zeros(n_jobs, np.int32)
        w_off = np.zeros(n_jobs, np.int64)
        w_len = np.zeros(n_jobs, np.int32)
        for i in range(n_jobs):
            L = int(rs.randint(20, Lmax + 1))
            G = int(rs.randint(L, L + 300))
            p = int(rs.randint(0, len(text) - G))
            q = int(rs.randint(0, G - L + 1))
            rd = text[p + q:p + q + L].copy()
            for _ in range(rs.randint(0, 6)):
                c = rs.randint(0, L)
                rd[c] = (rd[c] + rs.randint(1, 4)) % 4
            if rs.rand() < 0.3 and L > 20:   # 1bp deletion from the read
                rd = np.delete(text[p + q:p + q + L + 1].copy(), L // 2)
            rbuf[i, :len(rd)] = rd
            r_len[i] = len(rd)
            w_off[i] = p
            w_len[i] = G
        cost, start, ops = refpack.glocal_batch(
            rbuf, r_off, r_len, text, w_off, w_len, 3, 11, 4)
        for i in range(n_jobs):
            rd = rbuf[i, :r_len[i]].astype(np.int8)
            win = text[w_off[i]:w_off[i] + w_len[i]]
            c2, s2, cg2 = fit_in_window(rd, win, 3, 11, 4)
            assert int(cost[i]) == c2, i
            assert int(start[i]) == s2, i
            runs = []
            for op in ops[i]:
                ch = "MID"[op]
                if runs and runs[-1][0] == ch:
                    runs[-1] = (ch, runs[-1][1] + 1)
                else:
                    runs.append((ch, 1))
            assert runs == [(a, b) for a, b in cg2], i
