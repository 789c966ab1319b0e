"""Card-only checks: the selection and the beam ladder as compiled for the
GPU equal their CPU results.  Run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hsa_tpu.config import AlnOpt
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.kernels.select import KEY_SH, SENT, select_topk
from hsa_tpu.search.adaptive import AdaptiveBeam, finalize_any

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("C,K,B", [(72, 8, 16_384), (576, 64, 8_192),
                                   (352, 32, 8_192)])
def test_select_on_gpu_equals_cpu(gpu, C, K, B):
    rs = np.random.RandomState(C)
    col = np.arange(C, dtype=np.uint32)[:, None]
    key = (rs.randint(0, 60, (C, B)).astype(np.uint32) << KEY_SH) | col
    key = np.where(rs.rand(C, B) > 0.6, SENT | col, key).astype(np.uint32)
    pays = tuple(rs.randint(0, 2**31, (C, B)).astype(np.uint32)
                 for _ in range(3))
    win = rs.randint(5, 50, B).astype(np.uint32)
    fn = jax.jit(lambda k, p, w: select_topk(k, p, K, window=w))
    outs = []
    for dev in (gpu, jax.devices("cpu")[0]):
        args = jax.device_put((key, pays, win), dev)
        outs.append(jax.tree_util.tree_leaves(fn(*args)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_beam_ladder_on_gpu_equals_cpu(gpu):
    t = np.random.RandomState(7).randint(0, 4, 200_000).astype(np.int8)
    di = build_device_index(t)
    rs = np.random.RandomState(1)
    B, L = 512, 100
    fwd = np.stack([t[p:p + L] for p in rs.randint(0, len(t) - L, B)])
    for j in range(B):
        for q in rs.randint(0, L, j % 4):
            fwd[j, q] = (fwd[j, q] + 1) % 4
    args = (fwd.astype(np.uint8), np.full(B, L, np.int32),
            np.zeros((B, L), np.int32), np.full(B, 3, np.int32))
    opt = AlnOpt(max_diff=3)
    res = []
    for dev in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            ab = AdaptiveBeam(di.as_jax(), opt, ladder=(8, 64), max_hits=32)
            res.append(finalize_any(ab(*(jnp.asarray(a) for a in args)),
                                    opt.s_mm))
    for a, b in zip(*res):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
