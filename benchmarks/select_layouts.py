"""Time the beam ladder under each candidate top-K selection.

The beam engine's only cross-row operation is ``select_topk``
(``hsa_tpu/kernels/select.py``): two calls per scan step, on [C, B]
candidate matrices (C = 72..576 rows, K = 8..64).  This script swaps in
each candidate selection, times the beam on the shapes the aligner runs,
and checks that every candidate returns the same raw results:

- ``sort_bc``: multi-operand ``lax.sort`` over the minor axis of the
  transposed [B, C] (kept, ``select_topk``);
- ``sort_cb``: the same sort over axis 0 of [C, B];
- ``top_k``:  ``lax.top_k`` of the complemented keys on [B, C], payloads
  gathered by index.

Shapes (B = reads, lanes = 2B for both strands): the full ladder (8, 64)
at B = 16,384 (``align --engine beam``), and the widest rung (64,) at the
pooled-flush pad classes B = 512 / 2,048 / 8,192 (``Aligner._beam_rerun``).

    python benchmarks/select_layouts.py [--index PREFIX] [--iters N]

PREFIX defaults to the index chip_smoke.py builds (.cache/smoke/ref).
Prints one JSON line per (variant, shape) and the card's name and power
limit; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from hsa_tpu.kernels.select import KEY_SH, SENT, select_topk  # noqa: E402

U32 = jnp.uint32


def _window(key, window):
    if window is None:
        return key
    win = window.astype(U32).reshape(1, key.shape[1])
    return jnp.where((key >> KEY_SH) > win, SENT | key, key)


def _drops(key, K, drop_accum):
    nvalid = (key < SENT).sum(axis=0, dtype=jnp.int32)
    nd = jnp.maximum(nvalid - K, 0).astype(U32).reshape(1, key.shape[1])
    if drop_accum is not None:
        nd = drop_accum.astype(U32).reshape(1, key.shape[1]) + nd
    return nd


def sort_cb(key, payloads, K, window=None, drop_accum=None):
    key = _window(key, window)
    nd = _drops(key, K, drop_accum)
    sk, *pouts = lax.sort((key, *payloads), dimension=0, num_keys=1)
    return (jnp.concatenate([sk[:K], nd], axis=0),
            tuple(p[:K] for p in pouts), nd)


def top_k(key, payloads, K, window=None, drop_accum=None):
    key = _window(key, window)
    nd = _drops(key, K, drop_accum)
    kt = key.T
    _, idx = lax.top_k(~kt, K)
    take = lambda a: jnp.take_along_axis(a.T, idx, axis=1).T  # noqa: E731
    return (jnp.concatenate([take(key), nd], axis=0),
            tuple(take(p) for p in payloads), nd)


VARIANTS = {"sort_bc": select_topk, "sort_cb": sort_cb, "top_k": top_k}
SHAPES = [((8, 64), 16_384), ((64,), 512), ((64,), 2_048), ((64,), 8_192)]


def run(al, shapes, iters, card=""):
    """Time every variant on every (ladder, reads) shape; rows as dicts."""
    from chip_smoke import se_reads
    from hsa_tpu import alphabet
    from hsa_tpu.search import beam
    from hsa_tpu.search.adaptive import AdaptiveBeam
    from hsa_tpu.search.jitcache import jit_over_idx
    from hsa_tpu.search.widths import cal_width_device
    bmax = max(b for _, b in shapes)
    reads = [r for r in se_reads(al.text, bmax, 100) if len(r) == 100]
    reads = (reads * 2)[:bmax]
    fwd_all = np.stack(reads + [alphabet.revcomp(r) for r in reads]).astype(
        np.uint8)
    md = al.opt.diff_budget(100)
    width = jit_over_idx(al.dev, cal_width_device)
    rows = []
    try:
        for ladder, B in shapes:
            # reads j < B on both strands
            sel = np.concatenate([np.arange(B), bmax + np.arange(B)])
            fwd = jnp.asarray(fwd_all[sel])
            lens = jnp.full(2 * B, 100, jnp.int32)
            mds = jnp.full(2 * B, md, jnp.int32)
            D = width(fwd, lens)
            ref = None
            for name, fn in VARIANTS.items():
                beam.select_topk = fn
                ab = AdaptiveBeam(al.dev, al.opt, ladder=ladder, max_hits=32)
                t0 = time.perf_counter()
                res = jax.block_until_ready(ab(fwd, lens, D, mds))
                first = time.perf_counter() - t0
                ts = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    res = jax.block_until_ready(ab(fwd, lens, D, mds))
                    ts.append(time.perf_counter() - t0)
                leaves = [np.asarray(x)
                          for x in jax.tree_util.tree_leaves(res)]
                ref = leaves if ref is None else ref
                same = all(np.array_equal(x, y) for x, y in zip(leaves, ref))
                row = dict(variant=name, ladder=list(ladder), reads=B,
                           lanes=2 * B, ms_median=1e3 * float(np.median(ts)),
                           ms_all=[1e3 * t for t in ts], first_call_s=first,
                           same_as_kept=same, card=card,
                           device_kind=jax.devices()[0].device_kind)
                print(json.dumps(row), flush=True)
                rows.append(row)
                if not same:
                    raise RuntimeError(f"{name} differs from select_topk")
    finally:
        beam.select_topk = select_topk
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", default=None,
                    help="index prefix (default: chip_smoke.py's)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the rows here")
    a = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("select_layouts: needs a GPU")
    from hsa_tpu.cache import ROOT, enable_compile_cache
    from hsa_tpu.config import AlnOpt
    from hsa_tpu.pipeline import Aligner
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    al = Aligner(a.index or os.path.join(ROOT, "smoke", "ref"), AlnOpt())
    rows = run(al, SHAPES, a.iters, card)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
