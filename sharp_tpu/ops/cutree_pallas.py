"""Candidate-cut replay as one Pallas kernel through Triton (GPU).

`ops.linkage.cutree_multi` replays a merge sequence once and snapshots
the labelling at every candidate k. In XLA that is a `fori_loop` of
n_pad - 1 dependent O(n) steps, and on a GPU each step is a separate
launch whose fixed cost dwarfs its work. Here the whole loop runs inside
one program per (fold, member): the label vector lives in registers for
the entire replay (2,048 int32 over 8 warps is 8 registers a thread),
each step reads its merge pair as two scalar loads, and a snapshot row
is stored straight to device memory only at the ncand steps that close
a candidate cut.

Triton blocks must have power-of-two sizes, so the label axis and the
candidate axis are padded up to powers of two and sliced back. Batching
(`jax.vmap` over folds and ensemble members) adds grid axes through
pallas_call's own batching rule: one program per batch element.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from sharp_tpu.ops.linkage import CutForest, densify_labels


# the fastest of 1, 2, 4 and 8 warps on the H100 at n_pad 2048 x 80
# problems (scripts/linkage_routing.py; PERF.md, "Bring-up findings")
NUM_WARPS = 8


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _replay_kernel(nr_ref, mi_ref, mj_ref, snaps_ref, *, n_steps, minN,
                   ncand):
    c2, n2 = snaps_ref.shape

    def zero_row(r, carry):
        snaps_ref[r, :] = jnp.zeros((n2,), jnp.int32)
        return carry

    jax.lax.fori_loop(0, c2, zero_row, 0)
    n_real = nr_ref[0]

    def step(t, labels):
        i = mi_ref[t]
        j = mj_ref[t]
        labels = jnp.where(labels == j, i, labels)
        ci = n_real - t - 1 - minN

        @pl.when((ci >= 0) & (ci < ncand))
        def _():
            snaps_ref[ci, :] = labels

        return labels

    jax.lax.fori_loop(
        0, n_steps, step, jax.lax.iota(jnp.int32, n2)
    )


def replay_snapshots(
    merges: jax.Array, n_real: jax.Array, *, minN: int, ncand: int,
    num_warps: int = NUM_WARPS, interpret: bool = False,
) -> jax.Array:
    """(ncand, n_pad) int32 representative-index labels after each
    candidate cut, from an (n_pad - 1, 2) merge sequence — the `snaps` of
    `cutree_multi`, bit for bit (rows of candidates the replay never
    reaches stay zero)."""
    npad = merges.shape[0] + 1
    n2 = _pow2(npad)
    c2 = _pow2(ncand)
    mi = jnp.zeros((n2,), jnp.int32).at[: npad - 1].set(merges[:, 0])
    mj = jnp.zeros((n2,), jnp.int32).at[: npad - 1].set(merges[:, 1])
    nr = jnp.asarray(n_real, jnp.int32).reshape(1)
    snaps = pl.pallas_call(
        functools.partial(
            _replay_kernel, n_steps=npad - 1, minN=minN, ncand=ncand
        ),
        out_shape=jax.ShapeDtypeStruct((c2, n2), jnp.int32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="cut_replay",
    )(nr, mi, mj)
    return snaps[:ncand, :npad]


@functools.partial(
    jax.jit,
    static_argnames=("minN", "ncand", "nc_pad", "num_warps", "interpret"),
)
def cutree_multi_pallas(
    merges: jax.Array,       # (n_pad - 1, 2) int32 merge sequence
    n_real: jax.Array,       # () traced
    real_mask: jax.Array,    # (n_pad,)
    maxN: jax.Array,         # () traced
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> CutForest:
    """All cuts k = minN .. minN+ncand-1 — the contract of
    `ops.linkage.cutree_multi`, with the merge replay in one kernel."""
    snaps = replay_snapshots(
        merges, n_real, minN=minN, ncand=ncand, num_warps=num_warps,
        interpret=interpret,
    )
    dense, k = jax.vmap(lambda l: densify_labels(l, real_mask, nc_pad))(snaps)
    ks = minN + jnp.arange(ncand)
    # nc_pad - 1 caps representable cuts (matches ops.linkage.cutree_multi)
    valid = (ks <= n_real - 1) & (ks <= maxN) & (ks <= nc_pad - 1)
    return CutForest(labels=dense, k=k, valid=valid)
