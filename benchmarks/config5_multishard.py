"""Config 5: sharded-BWT paired search at scale with the psum interval
merge across N>=2 index shards.

It executes on a virtual 8-device CPU mesh (JAX_PLATFORMS=cpu +
xla_force_host_platform_device_count=8) to exercise the full sharded
path.  CPU-mesh wall times are thread-barrier latency artifacts, so the
primary metrics here are the COMMUNICATION VOLUMES of the sharded step —
psum collective count and per-shard bytes merged per batch, counted
exactly from the traced jaxpr — for both the beam and the flagship
pigeon engines; these are the quantities that cross the interconnect
between cards.
"""

import os

# must precede jax import
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import numpy as np
from common import cached_index, report, sample_reads, setup_jax, timeit

N = int(os.environ.get("HSA_BENCH_C5_MBP", "32")) * 1_000_000
B = int(os.environ.get("HSA_BENCH_PAIRS", "256"))
L = 150
W = 32

_COLLECTIVE_PAT = ("psum", "all_gather", "reduce_scatter", "ppermute",
                   "all_to_all", "allreduce")


def _is_collective(name: str) -> bool:
    return any(p in name for p in _COLLECTIVE_PAT)


def collective_stats(fn, *args):
    """(sites, per-invocation per-shard bytes) of collectives in the traced
    step.  Loop bodies count once (a site inside a 32-step locate walk
    executes 32x at runtime); the numbers characterize the merge pattern,
    not total wire traffic."""
    import jax
    jaxpr = jax.make_jaxpr(fn)(*args)
    stats = [0, 0]

    def descend(p):
        if hasattr(p, "eqns"):          # raw Jaxpr (e.g. shard_map body)
            walk(p)
        elif hasattr(p, "jaxpr"):       # ClosedJaxpr (e.g. pjit)
            walk(p.jaxpr)
        elif isinstance(p, (list, tuple)):
            for q in p:
                descend(q)

    def walk(jx):
        for eq in jx.eqns:
            if _is_collective(eq.primitive.name):
                stats[0] += 1
                for v in eq.outvars:
                    sh = getattr(v.aval, "shape", ())
                    stats[1] += int(np.prod(sh, dtype=np.int64)
                                    * v.aval.dtype.itemsize) if sh else 4
            for p in eq.params.values():
                descend(p)
    walk(jaxpr.jaxpr)
    return stats


def main():
    jax = setup_jax(platform="cpu")
    import jax.numpy as jnp
    from hsa_tpu import alphabet
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.dist.mesh import ShardedIndex, make_mesh
    from hsa_tpu.search import pigeon as pg

    di, text = cached_index(f"c5_{N // 1_000_000}M", N)
    text = np.asarray(text, np.int8)
    opt = AlnOpt(max_diff=2)
    fwd = sample_reads(text, 2 * B, L, n_mm=2)
    lens = np.full(2 * B, L, np.int32)
    md = np.full(2 * B, 2, np.int32)
    args = (jnp.asarray(fwd), jnp.asarray(lens), jnp.asarray(md))

    # beam path across shard counts (wall = CPU-mesh artifact; kept for
    # the scaling shape only)
    results = {}
    stats_beam = None
    for n_shard in (1, 2, 4):
        n_data = min(2, 8 // n_shard)
        mesh = make_mesh(n_data, n_shard)
        sidx = ShardedIndex(di, mesh)
        width, beam = sidx.width_fn(), sidx.beam_fn(opt, beam_width=W,
                                                    max_hits=8)

        def step(rf, ln, md):
            return beam(rf, ln, width(rf, ln), md)

        if n_shard == 4:
            stats_beam = collective_stats(step, *args)
        dt, res = timeit(step, *args, iters=2)
        results[n_shard] = dt

    # flagship pigeon engine on the 4-shard mesh (gapped verify on)
    mesh = make_mesh(2, 4)
    sidx = ShardedIndex(di, mesh)
    popt = AlnOpt(max_diff=2, max_gapo=1)
    reads = [np.asarray(r, np.int8) for r in
             sample_reads(text, 2 * B, min(L, 100), n_mm=2)]
    both = reads + [alphabet.revcomp(r) for r in reads]
    batch = pg.pack_pigeon_batch(both, n_seg=3, seed_len=popt.seed_len)
    pmd = np.full(len(both), 2, np.int32)
    trows = jnp.asarray(pg.pack_text_rows(text))
    pfn = sidx.pigeon_fn(popt, 3, trows, cand_cap=16)
    stats_pig = collective_stats(lambda b, m: pfn(batch, pmd), 0, 0)
    dt_pig, pres = timeit(lambda: pfn(batch, pmd), iters=2)
    occs, fb, _miss = pg.pigeon_occurrences(pg.fetch_result(pres), len(reads),
                                     popt, 16)
    mapped = sum(1 for o in occs if o) / len(reads)

    base = results[1]
    report("sharded_pairs_per_s", B / results[4], "pairs/s",
           vs_baseline=base / results[4],
           genome_mbp=N // 1_000_000, pairs=B, backend="cpu-virtual-8dev",
           t_shard1_ms=round(results[1] * 1e3, 1),
           t_shard2_ms=round(results[2] * 1e3, 1),
           t_shard4_ms=round(results[4] * 1e3, 1),
           beam_psum_sites=stats_beam[0],
           beam_psum_kb_per_shard=round(stats_beam[1] / 1e3, 2),
           pigeon_psum_sites=stats_pig[0],
           pigeon_psum_kb_per_shard=round(stats_pig[1] / 1e3, 2),
           pigeon_ms=round(dt_pig * 1e3, 1),
           pigeon_mapped=round(mapped, 4))


if __name__ == "__main__":
    main()
