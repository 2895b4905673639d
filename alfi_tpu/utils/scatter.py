"""Scatter-add as gather+sum for FEM accumulation.

With ALFI_TPU_GATHER_SUM=1 (default_use_tables), every hot-loop ``zeros.at[idx].add(vals)`` is
transposed into a precomputed (nout, mu) gather table + sum over the
multiplicity axis (mu = max #contributions to any output row): gathers
and sums only, so the result is deterministic, unlike a scatter-add
that a GPU runs with atomics.  Tables are built on host once per static
index set.  The gather-sum changes only the summation order against the
native scatter, at ~eps-level differences.
"""

from __future__ import annotations

import os

import numpy as np


def make_gather_sum(indices, nout):
    """Build ``apply(vals) -> (nout, *rest)`` computing
    ``zeros((nout, *rest)).at[indices].add(vals)`` with gathers only.

    indices : host int array, any shape; entries outside [0, nout) are
        treated as padding and dropped (the reference scatter would have
        required a dump slot for them).
    vals passed to apply must have shape ``indices.shape + rest``.

    Two formulations, chosen by fetch count:

    * padded table (nout, mu): every output row fetches mu entries even
      when it receives 0 or 1 contributions — at patch-scatter shapes
      (59k contributions into 66k rows, mu ~ 7) that is ~8x the real
      work;
    * multiplicity-bucketed: rows grouped by their EXACT contribution
      count k, one (nb_k, k) gather+sum per count, then a single
      permutation gather assembles the output — total fetches =
      nin + nout.  Summation order per row is identical to the padded
      table (stable sort by destination), so the two are bitwise equal.
    """
    import jax.numpy as jnp

    idx = np.asarray(indices).reshape(-1)
    nin = idx.size
    valid = (idx >= 0) & (idx < nout)
    vpos = np.where(valid)[0]
    order = vpos[np.argsort(idx[vpos], kind="stable")]
    sr = idx[order]
    counts = np.bincount(sr, minlength=nout)
    mu = int(counts.max()) if nin else 0
    starts = np.concatenate([[0], np.cumsum(counts)])
    ndim_idx = np.asarray(indices).ndim
    shape_idx = np.asarray(indices).shape

    def _itype(n):
        return np.int32 if n < np.iinfo(np.int32).max else np.int64

    use_bucketed = (os.environ.get("ALFI_TPU_BUCKETED_SUM", "1") == "1"
                    # worth the extra permutation gather only when it
                    # saves >=30% of the padded table's fetches
                    and mu >= 2
                    and order.size + nout < 0.7 * nout * mu)

    if not use_bucketed:
        table = np.full((nout, max(mu, 1)), nin, dtype=np.int64)
        pos = np.arange(order.size) - starts[sr]
        table[sr, pos] = order
        # index range is [0, nin] (nin = pad slot); int32 halves
        # resident index memory across the per-level/per-color tables
        table_j = jnp.asarray(table.astype(_itype(nin)))

        def apply(vals):
            rest = vals.shape[ndim_idx:]
            v = vals.reshape((nin,) + rest)
            vpad = jnp.concatenate(
                [v, jnp.zeros((1,) + rest, dtype=v.dtype)], axis=0)
            return vpad[table_j].sum(axis=1)

    else:
        tables = []   # (jnp (nb, k) int) per distinct count k >= 1
        perm = np.full(nout, -1, dtype=np.int64)
        off = 0
        for k in np.unique(counts[counts > 0]):
            rows_k = np.where(counts == k)[0]
            tab_k = (starts[rows_k][:, None]
                     + np.arange(k)[None, :])
            tables.append(jnp.asarray(
                order[tab_k].astype(_itype(nin))))
            perm[rows_k] = off + np.arange(rows_k.size)
            off += rows_k.size
        # rows with zero contributions read the appended zero slot
        perm[perm < 0] = off
        perm_j = jnp.asarray(perm.astype(_itype(off + 1)))

        def apply(vals):
            rest = vals.shape[ndim_idx:]
            v = vals.reshape((nin,) + rest)
            parts = [
                (v[tab[:, 0]] if tab.shape[1] == 1
                 else v[tab].sum(axis=1))
                for tab in tables
            ]
            parts.append(jnp.zeros((1,) + rest, dtype=v.dtype))
            return jnp.concatenate(parts, axis=0)[perm_j]

    apply.indices_shape = shape_idx
    apply.mu = mu
    apply.nout = nout
    apply.bucketed = use_bucketed
    return apply


def default_use_tables():
    """Whether hot-loop scatter-adds become gather-sum tables: opt in
    with ALFI_TPU_GATHER_SUM=1.  XLA's scatter-add is the default: on
    the GPU the tables were no faster and neither arm repeats bitwise
    (PERF.md, backend A/B)."""
    return os.environ.get("ALFI_TPU_GATHER_SUM") == "1"
