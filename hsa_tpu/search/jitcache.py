"""Jit wrappers that pass index tables as ARGUMENTS, never closures.

A device array captured in a jitted closure is embedded in the HLO as a
literal constant; with multi-GB occ tables that literal is serialized into
the compile payload and the compile cache key.  Every jitted entry point
here takes the table arrays as explicit
arguments (XLA parameters) and rebuilds the index namespace inside the
traced function — the same pattern ``dist.mesh.ShardedIndex`` uses.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax

_ARRAY_FIELDS = ("C", "occ_blocks", "samples")
_OPT_FIELDS = ("rev_occ_blocks", "sa_direct")


def split_idx(idx):
    """(arrays tuple, meta dict) — arrays become jit arguments."""
    arrays = [getattr(idx, f) for f in _ARRAY_FIELDS]
    present = tuple(f for f in _OPT_FIELDS
                    if getattr(idx, f, None) is not None)
    arrays += [getattr(idx, f) for f in present]
    meta = dict(n=idx.n, primary=idx.primary, sa_intv=idx.sa_intv,
                rev_primary=getattr(idx, "rev_primary", None),
                present=present)
    return tuple(arrays), meta


def join_idx(meta, arrays):
    ns = dict(zip(_ARRAY_FIELDS, arrays[:len(_ARRAY_FIELDS)]))
    ns.update({f: None for f in _OPT_FIELDS})
    ns.update(zip(meta["present"], arrays[len(_ARRAY_FIELDS):]))
    return SimpleNamespace(n=meta["n"], primary=meta["primary"],
                           sa_intv=meta["sa_intv"],
                           rev_primary=meta["rev_primary"], **ns)


def jit_over_idx(idx, body):
    """jax.jit of ``body(idx, *data_args)`` with the tables as arguments.

    Returns a callable taking only the data args.
    """
    arrays, meta = split_idx(idx)

    @jax.jit
    def f(arrs, *data):
        return body(join_idx(meta, arrs), *data)

    return lambda *data: f(arrays, *data)
