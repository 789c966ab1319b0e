"""Glocal DP screen vs the host fit_in_window oracle (costs + end columns)."""

import numpy as np
import pytest

import jax.numpy as jnp

from hsa_tpu.kernels.sw import glocal_screen
from hsa_tpu.resolve.sampe import fit_in_window


def cases(rs, n, L=40, G=160):
    reads = np.zeros((n, L), np.int32)
    lens = np.full(n, L, np.int32)
    wins = rs.randint(0, 4, (n, G)).astype(np.int32)
    wlens = np.full(n, G, np.int32)
    expect = []
    for j in range(n):
        kind = j % 5
        if kind == 0:    # exact placement
            s = rs.randint(0, G - L)
            reads[j] = wins[j, s:s + L]
        elif kind == 1:  # 2 mismatches
            s = rs.randint(0, G - L)
            reads[j] = wins[j, s:s + L]
            for q in rs.choice(L, 2, replace=False):
                reads[j, q] = (reads[j, q] + 1) % 4
        elif kind == 2:  # deletion (read skips a window base)
            s = rs.randint(0, G - L - 1)
            w = wins[j, s:s + L + 1]
            cut = rs.randint(5, L - 5)
            reads[j] = np.concatenate([w[:cut], w[cut + 1:]])
        elif kind == 3:  # random read (poor fit)
            reads[j] = rs.randint(0, 4, L)
        else:            # shorter read + shorter window
            Ls = L - 7
            lens[j] = Ls
            wl = G - 13
            wlens[j] = wl
            s = rs.randint(0, wl - Ls)
            reads[j, :Ls] = wins[j, s:s + Ls]
        expect.append(None)
    return reads, lens, wins, wlens


def oracle_cost(read, window):
    c, s, _ = fit_in_window(read, window, 3, 11, 4)
    return c


def test_jnp_screen_matches_host_dp():
    rs = np.random.RandomState(0)
    reads, lens, wins, wlens = cases(rs, 20)
    cost, end = glocal_screen(jnp.asarray(reads), jnp.asarray(lens),
                              jnp.asarray(wins), jnp.asarray(wlens), 3, 11, 4)
    cost, end = np.asarray(cost), np.asarray(end)
    for j in range(len(reads)):
        exp = oracle_cost(reads[j][:lens[j]], wins[j][:wlens[j]])
        assert cost[j] == exp, (j, cost[j], exp)
        # end column consistency: an alignment ending at `end` with that cost
        # must exist — re-run host DP on the truncated window
        if exp < (1 << 28):
            c2 = oracle_cost(reads[j][:lens[j]], wins[j][:end[j]])
            assert c2 == exp


def test_screen_rejects_junk():
    rs = np.random.RandomState(2)
    reads = rs.randint(0, 4, (4, 50)).astype(np.int32)
    wins = rs.randint(0, 4, (4, 200)).astype(np.int32)
    cost, _ = glocal_screen(jnp.asarray(reads), jnp.asarray(np.full(4, 50, np.int32)),
                            jnp.asarray(wins), jnp.asarray(np.full(4, 200, np.int32)),
                            3, 11, 4)
    # random 50bp in random 200bp window: expect >= ~8 mismatch-equivalents
    assert (np.asarray(cost) > 8 * 3).all()
