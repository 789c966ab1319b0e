"""hsa-tpu: a batched short-read DNA alignment engine in JAX.

A from-scratch re-architecture of the BWA-0.5.x-lineage BWT/FM-index inexact
aligner (the core of the reference `BioinformaticsArchive/HSA`) for a
data-parallel accelerator:

- the per-read branch-and-bound DFS (reference: ``bwtgap.c`` ``gap_push`` /
  ``gap_pop``) becomes a pigeonhole seed-and-verify fast path with a
  fixed-depth, batched beam search as exact fallback, where thousands of
  reads advance SA-interval frontiers in lockstep (``hsa_tpu.search``);
- pointer-chasing occ counts (reference: ``bwt.c`` ``bwt_2occ4``) become
  fused rank-indexed rows, one gather per rank query
  (``hsa_tpu.index.layout`` + ``hsa_tpu.search.fm``);
- hit resolution (locate, CIGAR, MAPQ, pairing, mate rescue) runs on the
  host over flat occurrence arrays (``hsa_tpu.resolve``);
- index construction (2-bit packing, SA-IS, BWT), read packing and the
  mate-rescue DP are a native C++ library (``hsa_tpu.refpack``);
- large references shard across devices via ``jax.sharding`` +
  ``shard_map`` with a psum interval merge (``hsa_tpu.dist``).

Provenance: the reference sources were not available when this was
written, so citations name upstream-lineage files/functions (e.g.
``bwtgap.c:bwt_match_gap``) of the BWA-0.5.x lineage, not file:line.
Ground truth for output parity is the in-repo oracle (``hsa_tpu.oracle``),
a direct implementation of the documented branch-and-bound semantics
(SURVEY.md Appendix A).
"""

__version__ = "0.1.0"
