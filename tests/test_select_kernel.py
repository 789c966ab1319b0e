"""select_topk vs a numpy iterative-min reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from hsa_tpu.kernels.select import KEY_SH, SENT, select_topk


def make_case(C, B, seed, frac_valid=0.7, with_window=False,
              with_accum=False):
    rs = np.random.RandomState(seed)
    score = rs.randint(0, 50, (C, B)).astype(np.uint32)
    col = np.arange(C, dtype=np.uint32)[:, None]
    key = (score << KEY_SH) | col
    invalid = rs.rand(C, B) > frac_valid
    key = np.where(invalid, (SENT | col).astype(np.uint32), key)
    pays = tuple(rs.randint(0, 2**31, (C, B)).astype(np.uint32)
                 for _ in range(2))
    win = rs.randint(5, 40, B).astype(np.uint32) if with_window else None
    acc = (rs.randint(0, 9, (1, B)).astype(np.uint32) if with_accum
           else None)
    return key, pays, win, acc


def reference_topk(key, pays, K, window=None, drop_accum=None):
    """K rounds of column-wise min: (keys [K, B], payloads, drops [B])."""
    key = key.astype(np.int64)
    if window is not None:
        key = np.where((key >> KEY_SH) > window[None, :], int(SENT), key)
    valid = key < int(SENT)
    drops = np.maximum(valid.sum(axis=0) - K, 0)
    if drop_accum is not None:
        drops = drops + drop_accum.reshape(-1)
    okey = np.empty((K, key.shape[1]), np.int64)
    opay = [np.empty((K, key.shape[1]), np.int64) for _ in pays]
    key = np.where(valid, key, 1 << 40)     # invalid rows sort last
    for s in range(K):
        m = key.min(axis=0)
        hit = key == m[None, :]
        okey[s] = m
        for o, p in zip(opay, pays):
            o[s] = np.where(hit, p, 0).sum(axis=0)
        key = np.where(hit, 1 << 41, key)
    return okey, opay, drops


def check_against_reference(C, B, K, window, accum):
    key, pays, win, acc = make_case(C, B, seed=C + B, with_window=window,
                                    with_accum=accum)
    rk, rp, rd = reference_topk(key, pays, K, win, acc)
    kkd, kp, kd = select_topk(
        jnp.asarray(key), tuple(jnp.asarray(p) for p in pays), K,
        None if win is None else jnp.asarray(win),
        None if acc is None else jnp.asarray(acc))
    kkd = np.asarray(kkd)
    assert kkd.shape == (K + 1, B)
    kk = kkd[:K].astype(np.int64)
    rvalid = rk < int(SENT)
    np.testing.assert_array_equal(rvalid, kk < int(SENT))
    np.testing.assert_array_equal(np.where(rvalid, rk, 0),
                                  np.where(rvalid, kk, 0))
    for a, b in zip(rp, kp):
        np.testing.assert_array_equal(np.where(rvalid, a, 0),
                                      np.where(rvalid, np.asarray(b), 0))
    np.testing.assert_array_equal(kkd[K], rd)
    np.testing.assert_array_equal(np.asarray(kd).reshape(-1), rd)


@pytest.mark.parametrize("C,B,K,window", [
    (32, 64, 8, False), (72, 128, 8, True), (56, 96, 16, False),
    (17, 33, 4, True),  # odd shapes
])
def test_kernel_matches_reference(C, B, K, window):
    # a running drop counter on every third batch width (96 and 33)
    check_against_reference(C, B, K, window, accum=B % 3 == 0)


def test_widest_rung_shape():
    """The frontier selection of the widest beam rung: C = 9 * 64, K = 64."""
    check_against_reference(576, 48, 64, window=True, accum=False)


def test_all_invalid_column():
    key, pays, _, _ = make_case(16, 32, seed=1, frac_valid=0.0)
    kkd, _, kd = select_topk(jnp.asarray(key),
                             tuple(jnp.asarray(p) for p in pays), 4)
    assert not (np.asarray(kkd)[:4] < SENT).any()
    assert (np.asarray(kd) == 0).all()
    assert (np.asarray(kkd)[4] == 0).all()
