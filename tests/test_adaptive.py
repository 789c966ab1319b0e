"""Adaptive beam ladder: same hit sets as a flat top-width run."""

import numpy as np
import pytest

import jax.numpy as jnp

from hsa_tpu.config import AlnOpt
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.search.adaptive import AdaptiveBeam, finalize_any
from hsa_tpu.search.beam import beam_search
from hsa_tpu.search.widths import cal_width_device


def test_ladder_matches_flat_top_width():
    t = np.random.RandomState(7).randint(0, 4, 60_000).astype(np.int8)
    dev = build_device_index(t).as_jax()
    opt = AlnOpt(max_diff=2)
    rs = np.random.RandomState(1)
    B, L = 48, 60
    fwd = np.full((B, L), 5, np.uint8)
    for j in range(B):
        p = rs.randint(0, len(t) - L)
        r = t[p:p + L].copy()
        r[rs.randint(0, L)] = (r[rs.randint(0, L)] + 1) % 4
        fwd[j] = r
    lens = np.full(B, L, np.int32)
    md = np.full(B, 2, np.int32)
    D = np.asarray(cal_width_device(dev, jnp.asarray(fwd), jnp.asarray(lens)))

    flat = finalize_any(
        beam_search(dev, jnp.asarray(fwd), jnp.asarray(lens), jnp.asarray(D),
                    jnp.asarray(md), opt, beam_width=512, max_hits=16), opt.s_mm)
    ladder = finalize_any(
        AdaptiveBeam(dev, opt, ladder=(8, 64, 512), max_hits=16,
                     esc_frac=1.0)(fwd, lens, D, md), opt.s_mm)

    def hitsets(res):
        out = []
        hv = np.asarray(res.hit_valid)
        for j in range(B):
            s = set()
            for h in range(hv.shape[1]):
                if hv[j, h]:
                    s.add((int(np.asarray(res.hit_score)[j, h]),
                           int(np.asarray(res.hit_k)[j, h]),
                           int(np.asarray(res.hit_l)[j, h])))
            out.append(s)
        return out

    flat_sets = hitsets(flat)
    lad_sets = hitsets(ladder)
    flat_of = np.asarray((flat.n_live_dropped > 0) | (flat.n_hits_dropped > 0))
    lad_of = np.asarray((ladder.n_live_dropped > 0) | (ladder.n_hits_dropped > 0))
    for j in range(B):
        # wherever neither run overflowed at top width, the hit sets must agree
        if not flat_of[j] and not lad_of[j]:
            assert flat_sets[j] == lad_sets[j], j
    # escalation resolved most reads without overflow at the top width
    assert lad_of.mean() <= flat_of.mean() + 1e-9


def test_ladder_single_rung_equals_beam():
    t = np.random.RandomState(9).randint(0, 4, 20_000).astype(np.int8)
    dev = build_device_index(t).as_jax()
    opt = AlnOpt(max_diff=1, max_gapo=0)
    rs = np.random.RandomState(2)
    B, L = 16, 40
    fwd = np.full((B, L), 5, np.uint8)
    for j in range(B):
        p = rs.randint(0, len(t) - L)
        fwd[j] = t[p:p + L]
    lens = np.full(B, L, np.int32)
    md = np.full(B, 1, np.int32)
    D = np.zeros((B, L), np.int32)
    a = finalize_any(AdaptiveBeam(dev, opt, ladder=(64,), max_hits=8)(
        fwd, lens, D, md), opt.s_mm)
    b = finalize_any(beam_search(dev, jnp.asarray(fwd), jnp.asarray(lens),
                                 jnp.asarray(D), jnp.asarray(md), opt,
                                 beam_width=64, max_hits=8), opt.s_mm)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ladder_propagates_compile_error(monkeypatch):
    """A selection that fails to compile fails the call: no retry, no
    other selection path."""
    from hsa_tpu.search import beam

    calls = []

    def fails(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("RESOURCE_EXHAUSTED: Mosaic scoped vmem limit")

    monkeypatch.setattr(beam, "select_topk", fails)
    t = np.random.RandomState(3).randint(0, 4, 4_000).astype(np.int8)
    dev = build_device_index(t).as_jax()
    opt = AlnOpt(max_diff=1, max_gapo=0)
    B, L = 8, 30
    fwd = np.stack([t[i * 50:i * 50 + L] for i in range(B)]).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        AdaptiveBeam(dev, opt, ladder=(8, 64), max_hits=8)(
            fwd, lens, np.zeros((B, L), np.int32), np.full(B, 1, np.int32))
    assert len(calls) == 1
