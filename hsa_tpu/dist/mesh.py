"""Index sharding over a device mesh (BASELINE configs 4-5).

Mesh axes:
  ``data``  — reads are data-parallel (each data-slice owns a batch shard)
  ``shard`` — the occ/mark/sample tables of large references are sharded by
              block rows; small genomes replicate (n_shards=1)

Inside ``shard_map`` every FM primitive uses the masked-gather + psum merge
implemented in :mod:`hsa_tpu.search.fm` (the per-query form of the north
star's all-gather interval merge).  The mesh takes ``jax.devices()`` in
order; cards of one host are joined all to all, so no placement is
preferred.

Multi-host: call :func:`init_multihost` (a ``jax.distributed.initialize``
wrapper) before building the mesh; the same code then runs with global
arrays sharded across processes.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.layout import DeviceIndex
from ..search.beam import beam_search, RawBeamResult
from ..search import fm as _fm
from ..search.exact import exact_search


def make_mesh(n_data: int, n_shard: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_shard, \
        f"need {n_data * n_shard} devices, have {len(devices)}"
    arr = np.asarray(devices[:n_data * n_shard]).reshape(n_data, n_shard)
    return Mesh(arr, ("data", "shard"))


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None):
    """``jax.distributed.initialize`` wrapper (bootstrap for N>=2 hosts)."""
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes, process_id=process_id)


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    r = (-a.shape[0]) % mult
    if r == 0:
        return a
    pad = np.zeros((r,) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


class ShardedIndex:
    """Places a DeviceIndex's tables across the mesh's ``shard`` axis."""

    def __init__(self, di: DeviceIndex, mesh: Mesh):
        self.mesh = mesh
        self.n_shard = mesh.shape["shard"]
        self.meta = dict(n=np.uint32(di.n), primary=np.uint32(di.primary),
                         sa_intv=int(di.sa_intv),
                         rev_primary=np.uint32(di.rev_primary & 0xFFFFFFFF))
        ns = self.n_shard
        occ = _pad_rows(di.occ_blocks, ns)
        samples = _pad_rows(di.samples, ns)
        self.occ_rows = occ.shape[0] // ns
        self.n_samples = samples.shape[0] // ns
        sad = (_pad_rows(di.sa_direct, ns)
               if di.sa_direct is not None else None)
        self.n_sa = sad.shape[0] // ns if sad is not None else 0
        sh2 = NamedSharding(mesh, P("shard", None))
        sh1 = NamedSharding(mesh, P("shard"))
        rep = NamedSharding(mesh, P())

        def put(arr, sh):
            # make_array_from_callback works in both single-controller and
            # multi-process (each process materializes only its addressable
            # shards; every process holds the same host array)
            return jax.make_array_from_callback(arr.shape, sh,
                                                lambda idx: arr[idx])

        self.occ_blocks = put(occ, sh2)
        self.samples = put(samples, sh1)
        self.C = put(di.C, rep)
        if di.rev_occ_blocks is not None:
            rocc = _pad_rows(di.rev_occ_blocks, ns)
            self.rev_occ_blocks = put(rocc, sh2)
        else:
            self.rev_occ_blocks = None
        self.sa_direct = put(sad, sh1) if sad is not None else None

    def _index_args(self):
        args = [self.occ_blocks, self.samples, self.C]
        specs = [P("shard", None), P("shard"), P()]
        if self.rev_occ_blocks is not None:
            args += [self.rev_occ_blocks]
            specs += [P("shard", None)]
        if self.sa_direct is not None:
            args += [self.sa_direct]
            specs += [P("shard")]
        return args, specs

    def _local_idx(self, occ, samples, C, *rest):
        rest = list(rest)
        rev_occ = rest.pop(0) if self.rev_occ_blocks is not None else None
        sad = rest.pop(0) if self.sa_direct is not None else None
        s = lax.axis_index("shard").astype(jnp.int32)
        return SimpleNamespace(
            n=self.meta["n"], primary=self.meta["primary"],
            sa_intv=self.meta["sa_intv"], C=C,
            occ_blocks=occ, samples=samples,
            rev_occ_blocks=rev_occ,
            rev_primary=self.meta["rev_primary"],
            sa_direct=sad,
            shard_axis="shard",
            row_offset=s * self.occ_rows,
            rev_row_offset=s * self.occ_rows,
            sample_offset=s * self.n_samples,
            sa_offset=s * self.n_sa)

    # -- jitted entry points ------------------------------------------------
    def exact_fn(self):
        """jit fn(reads_rev [B,L], lens [B]) -> (k, l, matched), data-sharded."""
        iargs, ispecs = self._index_args()

        def core(reads_rev, lens, *idx_arrays):
            idx = self._local_idx(*idx_arrays)
            return exact_search(idx, reads_rev, lens)

        f = jax.shard_map(core, mesh=self.mesh,
                          in_specs=(P("data", None), P("data"), *ispecs),
                          out_specs=(P("data"), P("data"), P("data")),
                          check_vma=False)
        jf = jax.jit(f)
        return lambda reads_rev, lens: jf(reads_rev, lens, *iargs)

    def beam_fn(self, opt, beam_width=None, max_hits=32):
        """jit fn(reads_fwd, lens, D, max_diff) -> RawBeamResult, data-sharded.

        Raw [H, B]-layout results (reads on the LANE axis -> sharded along
        the second dim); finalize on host (search.adaptive.finalize_any)."""
        iargs, ispecs = self._index_args()

        def core(reads_fwd, lens, D, max_diff, *idx_arrays):
            idx = self._local_idx(*idx_arrays)
            return beam_search(idx, reads_fwd, lens, D, max_diff, opt,
                               beam_width=beam_width, max_hits=max_hits)

        out_specs = RawBeamResult(
            hkey=P(None, "data"), hit_k=P(None, "data"),
            hit_l=P(None, "data"), hit_meta=P(None, "data"),
            best_raw=P("data"), n_live_dropped=P("data"),
            n_hits_dropped=P("data"))
        f = jax.shard_map(core, mesh=self.mesh,
                          in_specs=(P("data", None), P("data"), P("data", None),
                                    P("data"), *ispecs),
                          out_specs=out_specs,
                          check_vma=False)
        jf = jax.jit(f)
        return lambda reads_fwd, lens, D, max_diff: jf(reads_fwd, lens, D,
                                                       max_diff, *iargs)

    def width_fn(self):
        """jit fn(reads_fwd, lens) -> D, data-sharded (needs reverse table)."""
        assert self.rev_occ_blocks is not None
        iargs, ispecs = self._index_args()
        from ..search.widths import cal_width_device

        def core(reads_fwd, lens, *idx_arrays):
            idx = self._local_idx(*idx_arrays)
            return cal_width_device(idx, reads_fwd, lens)

        f = jax.shard_map(core, mesh=self.mesh,
                          in_specs=(P("data", None), P("data"), *ispecs),
                          out_specs=P("data", None), check_vma=False)
        jf = jax.jit(f)
        return lambda reads_fwd, lens: jf(reads_fwd, lens, *iargs)

    def locate_fn(self):
        """jit fn(ranks uint32[R]) -> positions uint32[R], data-sharded."""
        iargs, ispecs = self._index_args()

        def core(ranks, *idx_arrays):
            idx = self._local_idx(*idx_arrays)
            return _fm.locate(idx, ranks)

        f = jax.shard_map(core, mesh=self.mesh,
                          in_specs=(P("data"), *ispecs),
                          out_specs=P("data"), check_vma=False)
        jf = jax.jit(f)
        return lambda ranks: jf(ranks, *iargs)

    def pigeon_fn(self, opt, n_seg, text_rows, cand_cap=16, with_kmer=False,
                  seg_cap=32, pool_mult=4):
        """jit fn(batch dict, md, [tk, tl]) -> PigeonResult, data-sharded.

        The flagship seed-and-verify engine on the sharded index: occ and
        sample tables stay sharded (every fm primitive inside
        pigeon_search runs the masked-gather + psum merge), while the
        packed text rows and the optional K-mer seed table replicate —
        ~0.8 GB + 128 MB at human scale, small next to the occ shards.

        The batch rides the SAME fused uint32 upload buffer as the
        one-device path (one ``pack_pigeon_upload`` buffer per data
        slice, stacked ``[n_data, L]`` and sharded on ``data``; vmask /
        seedmask derived on device).  ``fn`` accepts the dict from
        ``pack_pigeon_batch``; lanes must divide ``n_data``.
        """
        from ..search import pigeon as pg
        iargs, ispecs = self._index_args()
        n_data = self.mesh.shape["data"]
        jf_cache = {}

        def build(shape_loc):
            R_l, SL, B2_l, RW = shape_loc

            def core(buf, trows, *rest):
                rest = list(rest)
                tk = rest.pop(0) if with_kmer else None
                tl = rest.pop(0) if with_kmer else None
                idx = self._local_idx(*rest)
                (segs_rev, seg_lens, seg_off, kmer, kmer_ok, seg_short,
                 rw, nmask, lens, md) = pg.unpack_pigeon_upload(
                    buf.reshape(-1), shape_loc)
                seed = ((tk, tl, kmer, kmer_ok, seg_short)
                        if with_kmer else None)
                res = pg.pigeon_search(
                    idx, trows, segs_rev, seg_lens, seg_off, rw, nmask,
                    None, None, lens, md, opt, n_seg=n_seg,
                    cand_cap=cand_cap, seg_cap=seg_cap,
                    pool=pool_mult * B2_l, gpool=B2_l, kmer_seed=seed)
                # globalize the pool-2 lane owners AND the pool-1 slot ids
                # so host finalization sees batch-global indices
                off = lax.axis_index("data").astype(jnp.int32) * B2_l
                g_read = jnp.where(res.g_read < B2_l, res.g_read + off,
                                   n_data * B2_l)
                cidx = res.cidx + off * jnp.int32(cand_cap)
                return res._replace(g_read=g_read, cidx=cidx,
                                    n_gate=res.n_gate.reshape(1))

            from ..search.pigeon import PigeonResult
            kmer_specs = (P(), P()) if with_kmer else ()
            out_specs = PigeonResult(
                pos=P("data"), nmm=P("data"), valid=P("data"), cidx=P("data"),
                fallback=P("data"), n_cand=P("data"),
                g_q=P("data", None), g_key=P("data", None), g_read=P("data"),
                n_gate=P("data"), n_missed=P("data"))
            f = jax.shard_map(core, mesh=self.mesh,
                              in_specs=(P("data", None), P(), *kmer_specs,
                                        *ispecs),
                              out_specs=out_specs, check_vma=False)
            return jax.jit(f)

        def run(batch, md, tk=None, tl=None):
            B2 = batch["lens"].shape[0]
            assert B2 % n_data == 0, \
                f"lanes {B2} must divide the data axis {n_data}"
            B2_l = B2 // n_data
            SL = batch["segs_rev"].shape[1]
            md = np.asarray(md, np.int32)
            def lane_slice(v, sl):
                # seg-major [n_seg*B2, ...] rows -> the slice's lanes from
                # every segment block; per-lane [B2, ...] arrays slice flat
                if v.shape[0] == n_seg * B2:
                    return (v.reshape((n_seg, B2) + v.shape[1:])[:, sl]
                            .reshape((n_seg * B2_l,) + v.shape[1:]))
                return v[sl]

            bufs = []
            for s in range(n_data):
                sl = slice(s * B2_l, (s + 1) * B2_l)
                sub = {k: lane_slice(v, sl) for k, v in batch.items()}
                bufs.append(pg.pack_pigeon_upload(sub, md[sl])[0])
            buf2 = np.stack(bufs)
            shape_loc = (n_seg * B2_l, SL, B2_l, batch["rw"].shape[1])
            jf = jf_cache.get(shape_loc)
            if jf is None:
                jf = jf_cache[shape_loc] = build(shape_loc)
            args = [buf2, text_rows]
            if with_kmer:
                args += [tk, tl]
            return jf(*args, *iargs)
        return run
