"""Ward agglomerative clustering on an accelerator with static shapes.

The reference bottoms out in `stats::hclust(d, method="ward.D")`
(R/get_opt_hclust.R:76-83), Fortran code with data-dependent control flow.
The replacement here is a fixed-trip-count Lance-Williams loop over a
padded (n, n) distance matrix:

  * All n_pad points participate; padded points carry structural distances
    (PAD_PAD_DIST between themselves, PAD_REAL_DIST to real points, see
    sharp_tpu/ops/distance.py) so every real merge happens strictly before
    any padded merge. The loop always runs n_pad - 1 steps — no dynamic
    shapes, fully vmappable over the ensemble axis.
  * ward.D semantics: the Lance-Williams update
        d(i∪j, k) = ((n_i+n_k) d(i,k) + (n_j+n_k) d(j,k) - n_k d(i,j))
                    / (n_i + n_j + n_k)
    is applied to the *raw* input distances (R's "ward.D" treats the input
    as already-squared; scipy's `ward` is the ward.D2 variant — parity
    tests account for this, see tests/test_linkage.py).
  * `cutree` is re-designed: instead of cutting the dendrogram once per
    candidate k (the reference recomputes per k, R/get_opt_hclust.R:129-154),
    we replay the merge sequence once and snapshot the labelling at every
    candidate k in [minN, minN+ncand) — O(n^2) total.

Invariant maintained by the merge loop: D[a, b] == BIG exactly when a == b
or either cluster is dead, so the per-step argmin needs no extra masking
pass over the matrix.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sharp_tpu.ops.distance import BIG


class LinkageResult(NamedTuple):
    merges: jax.Array   # (n_pad - 1, 2) int32; col 0 = surviving (smaller) index
    heights: jax.Array  # (n_pad - 1,) f32 merge distances (ward.D heights)


def _prep_matrix(D: jax.Array) -> jax.Array:
    n = D.shape[-1]
    eye = jnp.eye(n, dtype=bool)
    return jnp.where(eye, BIG, D)


# Lance-Williams update coefficients for every hmethod the reference's
# hclust call accepts (R/get_opt_hclust.R:77: 'ward.D', 'ward.D2',
# 'single', 'complete', 'average', 'mcquitty', 'median', 'centroid').
# R applies the recurrence to the raw dissimilarities (ward.D2 to their
# squares). `monotone` marks methods whose updated distance is >= the
# merged pair's distance — the precondition for the lazy row-min cache.
def lw_update(method: str, dik, djk, h, ni, nj, nk):
    if method in ("ward.D", "ward.D2", "ward"):
        return ((ni + nk) * dik + (nj + nk) * djk - nk * h) / (ni + nj + nk)
    if method == "single":
        return jnp.minimum(dik, djk)
    if method == "complete":
        return jnp.maximum(dik, djk)
    if method == "average":
        return (ni * dik + nj * djk) / (ni + nj)
    if method == "mcquitty":
        return 0.5 * dik + 0.5 * djk
    if method == "median":
        return 0.5 * dik + 0.5 * djk - 0.25 * h
    if method == "centroid":
        s = ni + nj
        return (ni * dik + nj * djk) / s - (ni * nj * h) / (s * s)
    raise ValueError(f"unknown hmethod {method!r}")


MONOTONE_METHODS = frozenset(
    {"ward.D", "ward.D2", "ward", "single", "complete", "average", "mcquitty"}
)


BACKENDS = ("auto", "xla", "rnn", "rnn_bf16")


def _platform() -> str:
    """Platform that traced computations are placed on: the default
    device's when one is set (`jax.default_device`), else the default
    backend's."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def resolve_linkage_backend(backend: str, hmethod: str = "ward.D") -> str:
    """Resolve the "auto" backend on the platform computations run on.

    "xla" is the serial lazy-row-min loop (`ward_linkage_deferred`);
    "rnn" / "rnn_bf16" the reciprocal-NN ladder (`ward_linkage_rnn`) with
    f32 or bf16 matrix storage. On the GPU "auto" takes the f32 ladder at
    every pad: it matches the serial reference's merges on tie-free data
    and ran the 16-fold program 7.4x faster than the serial loop (PERF.md,
    "Bring-up findings"). bf16 storage ran it faster still but flips
    near-tie merges, so it stays an explicit choice. Elsewhere (the CPU)
    "auto" is the serial loop.

    Only "auto" is downgraded for non-ward hmethods; an explicitly
    requested ladder with a non-ward hmethod is an error (the ladder
    implements ward.D only — silently swapping in the much slower serial
    loop would hide the mismatch).
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown linkage backend {backend!r}; expected one of "
            f"{', '.join(BACKENDS)}"
        )
    if backend == "auto":
        return "rnn" if hmethod == "ward.D" and _platform() == "gpu" else "xla"
    if hmethod != "ward.D" and backend != "xla":
        raise ValueError(
            f"linkage backend {backend!r} implements ward.D only; "
            f"hmethod {hmethod!r} requires backend='xla' (or 'auto')"
        )
    return backend


@functools.partial(jax.jit, static_argnames=("method",))
def ward_linkage(D: jax.Array, method: str = "ward.D") -> LinkageResult:
    """Agglomeration over a padded distance matrix, any hmethod.

    D: (n_pad, n_pad) from `pearson_distance`/`similarity_to_distance`
    (structural padding already in place). Returns the full merge sequence;
    the first n_real - 1 merges are exactly the merges of the unpadded
    problem, in the same order as R's hclust. This full-argmin loop is the
    semantic reference implementation and is correct for every method,
    including the non-monotone centroid/median recurrences.
    """
    n = D.shape[-1]
    D = _prep_matrix(D)
    ar = jnp.arange(n)

    def step(t, carry):
        D, active, sizes, merges, heights = carry
        idx = jnp.argmin(D.reshape(-1))
        i0 = idx // n
        j0 = idx % n
        i = jnp.minimum(i0, j0)
        j = jnp.maximum(i0, j0)
        h = D.reshape(-1)[idx]

        ni = sizes[i]
        nj = sizes[j]
        nk = sizes
        dik = D[i, :]
        djk = D[j, :]
        formula = lw_update(method, dik, djk, h, ni, nj, nk)
        valid = active & (ar != i) & (ar != j)
        newrow = jnp.where(valid, formula, BIG)

        D = D.at[i, :].set(newrow)
        D = D.at[:, i].set(newrow)
        D = D.at[j, :].set(BIG)
        D = D.at[:, j].set(BIG)
        active = active.at[j].set(False)
        sizes = sizes.at[i].set(ni + nj)
        merges = merges.at[t, 0].set(i.astype(jnp.int32))
        merges = merges.at[t, 1].set(j.astype(jnp.int32))
        heights = heights.at[t].set(h)
        return D, active, sizes, merges, heights

    init = (
        D,
        jnp.ones((n,), dtype=bool),
        jnp.ones((n,), dtype=D.dtype),
        jnp.zeros((n - 1, 2), dtype=jnp.int32),
        jnp.zeros((n - 1,), dtype=D.dtype),
    )
    _, _, _, merges, heights = jax.lax.fori_loop(0, n - 1, step, init)
    return LinkageResult(merges=merges, heights=heights)


@jax.jit
def ward_linkage_fast(D: jax.Array) -> LinkageResult:
    """ward.D agglomeration with lazy row-minimum caching — O(n^2) typical.

    Same output as `ward_linkage`, but the per-step global argmin over the
    (n, n) matrix is replaced by an argmin over an (n,) row-minimum cache
    with fastcluster-style lazy revalidation. Invariant: rowmin[k] is
    always a LOWER BOUND on the true minimum of row k (ward.D updates can
    only raise an entry above min(d_ik, d_jk) >= the old row min, and
    removed columns only delete candidates), so popping the smallest
    cached value and revalidating just that row until it is exact yields
    the true global minimum. Revalidations read stored matrix entries —
    no recomputed arithmetic — so staleness checks are exact comparisons.
    """
    n = D.shape[-1]
    D = _prep_matrix(D)
    ar = jnp.arange(n)

    rowmin0 = jnp.min(D, axis=1)
    rowarg0 = jnp.argmin(D, axis=1).astype(jnp.int32)

    def step(t, carry):
        D, active, sizes, rowmin, rowarg, merges, heights = carry

        # --- pop + lazy revalidation loop --------------------------------
        def reval_cond(state):
            rowmin, rowarg, done = state
            return jnp.logical_not(done)

        def reval_body(state):
            rowmin, rowarg, _ = state
            i0 = jnp.argmin(rowmin)
            row = D[i0]
            m = jnp.min(row)
            a = jnp.argmin(row).astype(jnp.int32)
            exact = m <= rowmin[i0]  # stored == true min (can't be larger)
            rowmin = rowmin.at[i0].set(m)
            rowarg = rowarg.at[i0].set(a)
            return rowmin, rowarg, exact

        rowmin, rowarg, _ = jax.lax.while_loop(
            reval_cond, reval_body, (rowmin, rowarg, jnp.asarray(False))
        )

        i0 = jnp.argmin(rowmin)
        j0 = rowarg[i0]
        i = jnp.minimum(i0, j0)
        j = jnp.maximum(i0, j0)
        h = rowmin[i0]

        # --- Lance-Williams update --------------------------------------
        ni = sizes[i]
        nj = sizes[j]
        nk = sizes
        dik = D[i, :]
        djk = D[j, :]
        formula = ((ni + nk) * dik + (nj + nk) * djk - nk * h) / (ni + nj + nk)
        valid = active & (ar != i) & (ar != j)
        newrow = jnp.where(valid, formula, BIG)

        D = D.at[i, :].set(newrow)
        D = D.at[:, i].set(newrow)
        D = D.at[j, :].set(BIG)
        D = D.at[:, j].set(BIG)
        active = active.at[j].set(False)
        sizes = sizes.at[i].set(ni + nj)
        merges = merges.at[t, 0].set(i.astype(jnp.int32))
        merges = merges.at[t, 1].set(j.astype(jnp.int32))
        heights = heights.at[t].set(h)

        # --- cache maintenance -------------------------------------------
        # other rows: only column i changed (to newrow) and column j died;
        # lower-bound invariant keeps stale entries safe, exact improvements
        # are recorded eagerly
        better = newrow < rowmin
        rowmin = jnp.where(better, newrow, rowmin)
        rowarg = jnp.where(better, i.astype(jnp.int32), rowarg)
        # row i: exact from its fresh row; row j: dead
        rowmin = rowmin.at[i].set(jnp.min(newrow))
        rowarg = rowarg.at[i].set(jnp.argmin(newrow).astype(jnp.int32))
        rowmin = rowmin.at[j].set(BIG)
        return D, active, sizes, rowmin, rowarg, merges, heights

    init = (
        D,
        jnp.ones((n,), dtype=bool),
        jnp.ones((n,), dtype=D.dtype),
        rowmin0,
        rowarg0,
        jnp.zeros((n - 1, 2), dtype=jnp.int32),
        jnp.zeros((n - 1,), dtype=D.dtype),
    )
    out = jax.lax.fori_loop(0, n - 1, step, init)
    return LinkageResult(merges=out[5], heights=out[6])


@functools.partial(
    jax.jit, static_argnames=("flush", "unroll", "eager_w", "method")
)
def ward_linkage_deferred(
    D: jax.Array, flush: int = 64, unroll: int = 1, eager_w: int = 0,
    method: str = "ward.D",
) -> LinkageResult:
    """ward.D agglomeration with lazy row-min caching AND deferred column
    writes.

    `ward_linkage_fast` is still memory-bound: its per-step column scatter
    `D[:, i] = newrow` makes XLA stream the whole (n, n) matrix every
    merge. Here a merge writes only its (contiguous) row; the symmetric
    column entries in other rows go stale and are corrected *at read time*
    against a bounded dirty list (the ≤`flush` rows merged this epoch,
    freshness decided by per-row version stamps). Every `flush` steps one
    batched gather/scatter reconciles all dirty columns at once. Per-step
    HBM traffic drops from O(n^2) to O(n + flush).

    Output is bit-identical to `ward_linkage` (same pop order, same
    Lance-Williams arithmetic, corrections copy stored values — no
    recomputation drift). Restricted to monotone methods — the lazy
    lower-bound invariant needs updated distances >= min(d_ik, d_jk).
    """
    if method not in MONOTONE_METHODS:
        raise ValueError(
            f"hmethod {method!r} is non-monotone; use ward_linkage instead"
        )
    n = D.shape[-1]
    D = _prep_matrix(D)
    ar = jnp.arange(n)
    sentinel = n  # dirty-slot "empty" marker

    def corrected_row(D, active, rowver, dirty, k):
        """True (fresh) row k: stored row + dirty-column corrections."""
        row = D[k]
        cols = jnp.clip(dirty, 0, n - 1)
        vals = D[cols, k]
        fresh = (dirty < sentinel) & (rowver[cols] > rowver[k])
        row = row.at[cols].set(jnp.where(fresh, vals, row[cols]))
        return jnp.where(active & (ar != k), row, BIG)

    def make_step(offset):
        def step(se, carry):
            (D, active, sizes, rowver, rowmin, rowarg, dirty,
             merges, heights) = carry
            t = offset + se

            def reval_cond(state):
                return jnp.logical_not(state[2])

            def reval_body(state):
                rowmin, rowarg, _ = state
                i0 = jnp.argmin(rowmin)
                row = corrected_row(D, active, rowver, dirty, i0)
                m = jnp.min(row)
                a = jnp.argmin(row).astype(jnp.int32)
                exact = m <= rowmin[i0]
                rowmin = rowmin.at[i0].set(m)
                rowarg = rowarg.at[i0].set(a)
                return rowmin, rowarg, exact

            rowmin, rowarg, _ = jax.lax.while_loop(
                reval_cond, reval_body, (rowmin, rowarg, jnp.asarray(False))
            )

            i0 = jnp.argmin(rowmin)
            j0 = rowarg[i0]
            i = jnp.minimum(i0, j0)
            j = jnp.maximum(i0, j0)
            h = rowmin[i0]

            ni = sizes[i]
            nj = sizes[j]
            nk = sizes
            dik = corrected_row(D, active, rowver, dirty, i)
            djk = corrected_row(D, active, rowver, dirty, j)
            formula = lw_update(method, dik, djk, h, ni, nj, nk)
            valid = active & (ar != i) & (ar != j)
            newrow = jnp.where(valid, formula, BIG)

            D = D.at[i, :].set(newrow)
            rowver = rowver.at[i].set(t)
            active = active.at[j].set(False)
            sizes = sizes.at[i].set(ni + nj)
            merges = merges.at[t, 0].set(i.astype(jnp.int32))
            merges = merges.at[t, 1].set(j.astype(jnp.int32))
            heights = heights.at[t].set(h)

            better = newrow < rowmin
            rowmin = jnp.where(better, newrow, rowmin)
            rowarg = jnp.where(better, i.astype(jnp.int32), rowarg)
            rowmin = rowmin.at[i].set(jnp.min(newrow))
            rowarg = rowarg.at[i].set(jnp.argmin(newrow).astype(jnp.int32))
            rowmin = rowmin.at[j].set(BIG)

            dirty = dirty.at[se].set(i.astype(jnp.int32))

            # --- eager batched revalidation ------------------------------
            # the only rows whose cached min can be stale after this merge
            # are those that pointed at i or j; fix up to eager_w of them
            # in one batched gather (avg ~4 would otherwise pay a lazy
            # while-loop iteration each). Overflow stays safely lazy.
            if eager_w > 0:
                stale = active & ((rowarg == i) | (rowarg == j)) & (ar != i)
                idxs = jnp.nonzero(stale, size=eager_w, fill_value=j)[0]
                slot_ok = jnp.arange(eager_w) < jnp.sum(stale.astype(jnp.int32))
                rows = D[idxs]                                  # (W, n)
                cols = jnp.clip(dirty, 0, n - 1)
                vals = D[cols[:, None], idxs[None, :]]           # (F, W)
                fresh = (
                    (dirty < sentinel)[:, None]
                    & (rowver[cols][:, None] > rowver[idxs][None, :])
                )
                rows = jnp.transpose(
                    jnp.transpose(rows).at[cols].set(
                        jnp.where(fresh, vals, jnp.transpose(rows)[cols])
                    )
                )
                rows = jnp.where(
                    active[None, :] & (ar[None, :] != idxs[:, None]),
                    rows, BIG,
                )
                mins = jnp.min(rows, axis=1)
                args = jnp.argmin(rows, axis=1).astype(jnp.int32)
                rowmin = rowmin.at[idxs].set(
                    jnp.where(slot_ok, mins, rowmin[idxs])
                )
                rowarg = rowarg.at[idxs].set(
                    jnp.where(slot_ok, args, rowarg[idxs])
                )

            return (D, active, sizes, rowver, rowmin, rowarg, dirty,
                    merges, heights)

        return step

    def do_flush(D, rowver, dirty):
        cols = jnp.clip(dirty, 0, n - 1)
        dvalid = dirty < sentinel
        colvals = D[cols, :]                       # (F, n) fresh rows
        # reconcile within-dirty staleness: entry (a, b) should come from
        # whichever of row a / row b was written later
        sub = colvals[:, cols]                     # (F, F)
        ver = rowver[cols]
        fresher = ver[None, :] > ver[:, None]
        sub_corr = jnp.where(fresher, sub.T, sub)
        colvals = colvals.at[:, cols].set(sub_corr)
        # write columns, preserving entries in rows fresher than the column
        keep = rowver[:, None] > ver[None, :]      # (n, F)
        keep = keep | ~dvalid[None, :]
        cur = D[:, cols]
        newcols = jnp.where(keep, cur, colvals.T)
        return D.at[:, cols].set(newcols)

    carry = (
        D,
        jnp.ones((n,), dtype=bool),
        jnp.ones((n,), dtype=D.dtype),
        jnp.full((n,), -1, jnp.int32),
        jnp.min(D, axis=1),
        jnp.argmin(D, axis=1).astype(jnp.int32),
        jnp.full((flush,), sentinel, jnp.int32),
        jnp.zeros((n - 1, 2), dtype=jnp.int32),
        jnp.zeros((n - 1,), dtype=D.dtype),
    )
    done = 0
    while done < n - 1:
        steps = min(flush, n - 1 - done)
        carry = jax.lax.fori_loop(
            0, steps, make_step(done), carry, unroll=unroll
        )
        D_, active, sizes, rowver, rowmin, rowarg, dirty, merges, heights = carry
        D_ = do_flush(D_, rowver, dirty)
        dirty = jnp.full((flush,), sentinel, jnp.int32)
        carry = (D_, active, sizes, rowver, rowmin, rowarg, dirty,
                 merges, heights)
        done += steps
    return LinkageResult(merges=carry[7], heights=carry[8])


@functools.partial(
    jax.jit, static_argnames=("pair_cap", "store_dtype", "compact_n",
                              "compact_cap")
)
def ward_linkage_rnn(
    D: jax.Array, pair_cap: int = 128, store_dtype=None,
    compact_n: int = 256, compact_cap: int = 32,
) -> LinkageResult:
    """ward.D agglomeration by reciprocal-nearest-neighbor rounds — the
    data-parallel formulation.

    Ward's recurrence is *reducible*: if (a, b) are mutual nearest
    neighbours, no other merge can change d(a, b) or break their
    mutuality (d(a∪b, c) >= d(a, b) and d(a, c∪d) >= min(d(a,c), d(a,d))
    >= d(a, b)). Hence ALL current mutual-NN pairs can merge in one
    round, producing the same dendrogram as the serial global-argmin
    loop; the serial merge order is recovered afterwards by a stable
    sort on heights (Ward heights are monotone, and a parent is always
    recorded in a later round than its children, so the stable sort is
    topological even under ties).

    A size LADDER bounds the round count AND the round cost: rounds at
    each level run only until the survivors fit the next (half-size)
    level — 2-3 rounds each, since a round merges ~25-35% of clusters —
    then the survivors are compacted down; the long few-pairs-per-round
    tail runs at (compact_n, compact_n) where a round costs ~nothing.
    Each round:
    gather the merging rows with a one-hot matmul, Lance-Williams
    elementwise, pair-pair entries fixed by a second (cap x cap)
    contraction in within-round height order (the serial association),
    scatter rows/columns back with matmul + transpose selects.

    Heights equal the serial implementation's up to floating-point
    associativity (cross-pair updates apply the same LW steps in a
    possibly different association); merge pairs and all cuts are
    identical on tie-free data.

    `store_dtype` (default: D's dtype) is the matrix storage precision:
    bfloat16 halves the round-dominating memory traffic while the LW
    arithmetic stays f32.

    Exactness discipline: every matmul here carries either exact
    integers (merge indices, sizes, one-hot selectors) or stored
    distances whose bit pattern later argmins/compares depend on. A
    reduced-precision matmul (bf16 passes, TF32) silently rounds f32
    operands — at n = 2048 that corrupts merge indices (2047 -> 2048),
    duplicates pairs and breaks replay. All dots therefore run at
    Precision.HIGHEST (exact for f32; a no-op cost-wise for bf16
    operands). Recorded heights are additionally clamped to be >= the
    merging clusters' previous record (`lasth`), so the stable height
    sort that recovers the serial merge order stays topological even
    when bf16 storage rounds a parent height just below its child's.
    """
    n = D.shape[-1]
    dt = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    st = jnp.dtype(store_dtype) if store_dtype is not None else D.dtype
    D = _prep_matrix(D).astype(st)
    C = min(compact_n, n)
    P1 = min(pair_cap, n // 2)
    P2 = min(compact_cap, max(C // 2, 1))
    mbuf = n - 1 + max(P1, P2)
    bigst = jnp.asarray(BIG, st)

    # store-rounding must be REAL: under --xla_allow_excess_precision XLA
    # may elide an f32->bf16->f32 astype round-trip, and whether it does
    # depends on how the surrounding program fuses — two compiles of this
    # very function then disagree on stored values and, through bf16
    # ties, on merge order. lax.reduce_precision is the non-elidable
    # rounding op.
    if jnp.dtype(st) == jnp.bfloat16:
        def store_round(x):
            return jax.lax.reduce_precision(x, 8, 7)
    else:
        def store_round(x):
            return x

    def first_argmin(Dm):
        """Row min + FIRST-index argmin, deterministic across compiles.

        jnp.argmin's tie-break is first-index per spec, but a backend's
        reduction order — and with it which of several equal bf16
        entries wins — may vary between compiled programs. min-reduces
        of values and of masked int32 indices are exactly associative,
        so this construction is order-independent.
        """
        m = Dm.shape[-1]
        mnv = jnp.min(Dm, axis=1)
        idx = jnp.min(
            jnp.where(
                Dm == mnv[:, None], jnp.arange(m, dtype=jnp.int32)[None, :],
                m,
            ),
            axis=1,
        )
        return mnv.astype(dt), idx.astype(jnp.int32)

    def make_body(n_loc, P):
        ar = jnp.arange(n_loc)

        def body(c):
            D, alive, sizes, gidx, lasth, merges, heights, rounds, cnt = c
            af = alive
            rowmin, nn = first_argmin(D)
            pp = nn[nn]
            mutual = (pp == ar) & af & (rowmin < 0.5 * BIG)
            lead = mutual & (ar < nn)

            a = jnp.nonzero(lead, size=P, fill_value=0)[0].astype(jnp.int32)
            n_pairs = jnp.minimum(jnp.sum(lead.astype(jnp.int32)), P)
            sv = jnp.arange(P) < n_pairs
            b = jnp.where(sv, nn[a], 0)
            svf = sv.astype(st)

            OHa = (ar[None, :] == a[:, None]).astype(st) * svf[:, None]
            OHb = (ar[None, :] == b[:, None]).astype(st) * svf[:, None]
            # ONE stacked gather matmul: D (the round's dominant memory
            # operand) streams once instead of twice; each output row's
            # dot product is computed identically, so results are
            # bit-equal to separate Da/Db matmuls
            Dab = jnp.dot(
                jnp.concatenate([OHa, OHb], axis=0), D,
                preferred_element_type=dt, precision=hi,
            )
            Da, Db = Dab[:P], Dab[P:]
            na = sizes[a] * sv.astype(dt)
            nb = sizes[b] * sv.astype(dt)
            h = jnp.where(sv, rowmin[a], BIG)
            nk = sizes[None, :]
            S = (na + nb)[:, None] + nk
            newrows = (
                (na[:, None] + nk) * Da + (nb[:, None] + nk) * Db
                - nk * h[:, None]
            ) / S

            # pair-pair entries: the later merge's LW applied to the
            # earlier merge's fresh row — the serial association. Inputs
            # are store-rounded first (a later serial merge reads stored
            # values; reduce_precision so the rounding survives fusion).
            newrows_st = store_round(newrows).astype(st)
            newrows_rt = newrows_st.astype(dt)
            Ra = jnp.dot(
                newrows_rt, OHa.T.astype(dt), preferred_element_type=dt,
                precision=hi,
            )
            Rb = jnp.dot(
                newrows_rt, OHb.T.astype(dt), preferred_element_type=dt,
                precision=hi,
            )
            ne = na + nb
            # clamp: empty slots have zero sizes; a 0/0 NaN here would
            # poison the scatter matmuls through 0 * NaN
            denom = jnp.maximum((na + nb)[None, :] + ne[:, None], 1e-9)
            E = (
                (na[None, :] + ne[:, None]) * Ra
                + (nb[None, :] + ne[:, None]) * Rb
                - ne[:, None] * h[None, :]
            ) / denom
            earlier = (h[:, None] < h[None, :]) | (
                (h[:, None] == h[None, :]) & (a[:, None] < a[None, :])
            )
            V = store_round(jnp.where(earlier, E, E.T))

            cola = jnp.sum(OHa, axis=0) > 0.5
            pairfix = jnp.dot(
                V.astype(st), OHa, preferred_element_type=dt, precision=hi
            )
            newrows_st = jnp.where(
                cola[None, :], store_round(pairfix).astype(st), newrows_st
            )
            dying = jnp.sum(OHb, axis=0) > 0.5
            selfm = (OHa + OHb) > jnp.asarray(0.5, st)
            newrows_st = jnp.where(
                selfm | dying[None, :] | ~af[None, :], bigst, newrows_st
            )

            rowsfull = jnp.dot(
                OHa.T, newrows_st, preferred_element_type=st, precision=hi,
            )
            # colsfull == rowsfull.T bit-exactly (single-nonzero sums of
            # the same stored values); a second matmul stands in for the
            # transpose
            colsfull = jax.lax.dot_general(
                newrows_st, OHa,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=st,
                precision=hi,
            )
            D = jnp.where(
                dying[:, None] | dying[None, :], bigst,
                jnp.where(
                    cola[:, None], rowsfull,
                    jnp.where(cola[None, :], colsfull, D),
                ),
            )

            alive = af & ~dying
            sizes = sizes + jnp.dot(
                OHa.T.astype(dt), nb, preferred_element_type=dt,
                precision=hi,
            )

            # recorded height: clamp to >= the merging clusters' previous
            # recorded heights so the post-hoc stable height sort is
            # topological even under store rounding (exact LW already
            # guarantees h_parent >= h_child; rounding can break it)
            hrec = jnp.maximum(h, jnp.maximum(lasth[a], lasth[b]))
            hrec = jnp.where(sv, hrec, BIG)
            lasth_upd = jnp.sum(
                jnp.where(OHa > jnp.asarray(0.5, st),
                          jnp.where(sv, hrec, 0.0)[:, None], 0.0),
                axis=0,
            )
            lasth = jnp.where(cola, lasth_upd, lasth)

            # append records at offset cnt via an exact integer
            # select-sum (int32 end-to-end) — a dynamic_update_slice here
            # would lower to a serialized scatter loop under the vmapped
            # (batched-offset) call
            ga = gidx[a]
            gb = gidx[b]
            ents = jnp.stack(
                [jnp.where(sv, ga, 0), jnp.where(sv, gb, 0)], axis=1
            )                                             # (P, 2) int32
            pos = jnp.arange(mbuf)
            M = ((pos[:, None] - cnt) == jnp.arange(P)[None, :]) & sv[None, :]
            row_hit = jnp.any(M, axis=1)
            new_ents = jnp.sum(
                jnp.where(M[:, :, None], ents[None, :, :], 0), axis=1
            )                                             # (mbuf, 2) int32
            merges = jnp.where(row_hit[:, None], new_ents, merges)
            new_h = jnp.sum(
                jnp.where(M, jnp.where(sv, hrec, 0.0)[None, :], 0.0), axis=1
            )
            heights = jnp.where(row_hit, new_h, heights)
            return (D, alive, sizes, gidx, lasth, merges, heights,
                    rounds + 1, cnt + n_pairs)

        return body

    state = (
        D,
        jnp.ones((n,), bool),
        jnp.ones((n,), dt),
        jnp.arange(n, dtype=jnp.int32),
        jnp.zeros((n,), dt),  # lasth: running recorded-height per cluster
        jnp.zeros((mbuf, 2), jnp.int32),
        jnp.zeros((mbuf,), dt),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )

    def compact_to(state, n_from, Cn):
        """Gather the <= Cn survivors into a (Cn, Cn) subproblem."""
        D1, alive, sizes, gidx, lasth, merges, heights, rounds, cnt = state
        n_alive = jnp.sum(alive.astype(jnp.int32))
        surv = jnp.nonzero(alive, size=Cn, fill_value=0)[0].astype(jnp.int32)
        svC = jnp.arange(Cn) < n_alive
        OHs = (
            (jnp.arange(n_from)[None, :] == surv[:, None]).astype(st)
            * svC.astype(st)[:, None]
        )                                                    # (Cn, n_from)
        D2 = jnp.dot(
            jnp.dot(OHs, D1, preferred_element_type=st, precision=hi),
            OHs.T,
            preferred_element_type=st,
            precision=hi,
        )                                                    # (Cn, Cn)
        D2 = jnp.where(
            svC[:, None] & svC[None, :]
            & (jnp.arange(Cn)[:, None] != jnp.arange(Cn)[None, :]),
            D2, bigst,
        )
        sizes2 = jnp.where(
            svC, jnp.dot(OHs.astype(dt), sizes,
                         preferred_element_type=dt, precision=hi), 1.0
        )
        gidx2 = jnp.where(svC, gidx[surv], 0).astype(jnp.int32)
        lasth2 = jnp.where(svC, lasth[surv], 0.0)
        return (D2, svC, sizes2, gidx2, lasth2, merges, heights,
                jnp.asarray(0, jnp.int32), cnt)

    # ladder: at each size level, run rounds only until the survivors fit
    # the next (half-size) level, then compact down. The level cap
    # lvl // 2 can never bind (mutual pairs are disjoint), so a level
    # exits in the minimum number of rounds. rounds < n is a safety bound
    # (every round merges >= 1 pair — the global-min pair is mutual).
    lvl = n
    while lvl > C:
        nxt = max(lvl // 2, C)

        def cond_lvl(c, nxt=nxt):
            n_alive = jnp.sum(c[1].astype(jnp.int32))
            return (c[8] < n - 1) & (n_alive > nxt) & (c[7] < n)

        state = jax.lax.while_loop(
            cond_lvl, make_body(lvl, min(pair_cap, lvl // 2)), state
        )
        state = compact_to(state, lvl, nxt)
        lvl = nxt

    # tail: drain the compacted subproblem
    def cond_tail(c):
        return (c[8] < n - 1) & (c[7] < n)

    with jax.named_scope("ward_rnn_tail"):
        state = jax.lax.while_loop(cond_tail, make_body(lvl, P2), state)
    merges, heights = state[5][: n - 1], state[6][: n - 1]

    order = jnp.argsort(heights, stable=True)
    return LinkageResult(merges=merges[order], heights=heights[order])


def validate_merge_sequence(merges, heights, n_real: int, n_pad: int):
    """Host-side structural validation of a merge sequence.

    Returns a list of human-readable problem strings (empty = valid):
    index range, self-merges, duplicated pairs, replay viability (every
    merged-away j must be a live representative), and height monotonicity
    over the real merges. A reduced-precision matmul in the ladder once
    violated all of these at once; chip_smoke.py and bench.py check every
    device backend with it before they report anything.
    """
    import numpy as np

    errs = []
    m = np.asarray(merges)[: n_pad - 1]
    h = np.asarray(heights)[: n_pad - 1]
    if (m < 0).any() or (m >= n_pad).any():
        errs.append(
            f"indices out of range [0,{n_pad}): min={m.min()} max={m.max()}"
        )
        return errs
    n_self = int((m[:, 0] == m[:, 1]).sum())
    if n_self:
        errs.append(f"{n_self} self-merges")
    seen = set()
    dups = 0
    for a, b in m:
        if (a, b) in seen:
            dups += 1
        seen.add((a, b))
    if dups:
        errs.append(f"{dups} duplicated pairs")
    lab = np.arange(n_pad)
    viol = 0
    for a, b in m:
        if not (lab == b).any():
            viol += 1
        lab[lab == b] = a
    if viol:
        errs.append(f"{viol} replay violations (merged-away index reused)")
    hr = h[: n_real - 1]
    drops = int(
        (np.diff(hr) < -1e-5 * np.maximum(np.abs(hr[:-1]), 1e-9)).sum()
    )
    if drops:
        errs.append(f"{drops} height-order drops in real merges")
    return errs


class CutForest(NamedTuple):
    labels: jax.Array        # (ncand, n_pad) int32 dense labels in [0, k); pads -> nc_pad-1
    k: jax.Array             # (ncand,) int32 actual cluster count per candidate
    valid: jax.Array         # (ncand,) bool — candidate k is testable (k <= n_real-1, k <= maxN)


def densify_labels(lab: jax.Array, real_mask: jax.Array, nc_pad: int):
    """Map representative-index labels to dense ids 0..k-1 (first-index order).

    Padded cells are routed to the reserved garbage slot nc_pad - 1.

    Gather/scatter-free: a merge-replay representative always carries its own
    index (merges relabel j -> i with i < j, so lab[r] == r exactly for
    representatives), which makes occupancy an elementwise compare, and
    the dense id of each cell a compare against the <= nc_pad
    representative indices instead of a newid[lab] lookup.
    """
    n = lab.shape[0]
    ar = jnp.arange(n)
    occ = ((lab == ar) & real_mask).astype(jnp.int32)
    k = jnp.sum(occ)
    # representative lane index of each dense id, scatter-free: newid is
    # the dense id of representative r, so reps[c] = the unique r with
    # occ[r] and newid[r] == c (empty ids get the out-of-range fill n)
    newid = jnp.cumsum(occ) - 1
    sel = (newid[None, :] == jnp.arange(nc_pad)[:, None]) & (
        occ[None, :] > 0
    )                                                        # (nc_pad, n)
    reps = jnp.where(
        jnp.any(sel, axis=1),
        jnp.sum(jnp.where(sel, ar[None, :], 0), axis=1),
        n,
    )                                                        # (nc_pad,)
    eq = lab[:, None] == reps[None, :]                       # (n, nc_pad)
    dense = jnp.sum(
        jnp.where(eq, jnp.arange(nc_pad, dtype=jnp.int32)[None, :], 0),
        axis=1,
    )
    dense = jnp.where(real_mask, dense, nc_pad - 1)
    return dense.astype(jnp.int32), k


@functools.partial(jax.jit, static_argnames=("minN", "ncand", "nc_pad"))
def cutree_multi(
    merges: jax.Array,
    n_real: jax.Array,
    real_mask: jax.Array,
    maxN: jax.Array,
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
) -> CutForest:
    """All cuts k = minN .. minN+ncand-1 from one merge-sequence replay.

    Matches `cutree(h, k)` for each candidate k (R/get_opt_hclust.R:113,132)
    but in a single O(n_pad^2) pass. `n_real`/`maxN` may be traced scalars.
    """
    npad = real_mask.shape[0]
    labels0 = jnp.arange(npad, dtype=jnp.int32)
    snaps0 = jnp.zeros((ncand, npad), dtype=jnp.int32)

    def step(t, carry):
        labels, snaps = carry
        i = merges[t, 0]
        j = merges[t, 1]
        labels = jnp.where(labels == j, i, labels)
        k_now = n_real - t - 1
        ci = k_now - minN
        ok = (ci >= 0) & (ci < ncand)
        cidx = jnp.clip(ci, 0, ncand - 1)
        row = jnp.where(ok, labels, snaps[cidx])
        snaps = snaps.at[cidx].set(row)
        return labels, snaps

    _, snaps = jax.lax.fori_loop(0, npad - 1, step, (labels0, snaps0))

    dense, k = jax.vmap(lambda l: densify_labels(l, real_mask, nc_pad))(snaps)
    ks = minN + jnp.arange(ncand)
    # nc_pad - 1 caps representable cuts (dense ids must clear the
    # reserved garbage slot)
    valid = (ks <= n_real - 1) & (ks <= maxN) & (ks <= nc_pad - 1)
    return CutForest(labels=dense, k=k, valid=valid)


def real_heights_tail(heights: jax.Array, n_real: jax.Array, tail: int = 10):
    """Last `tail` real merge heights, ascending — the reference's
    `tail(h$height, n=10)` (R/get_opt_hclust.R:199).

    Real merges occupy indices [0, n_real-1) of `heights`; later entries are
    structural pad merges. When fewer than `tail` real merges exist, the
    trailing invalid slots are filled with the last valid height so adjacent
    diffs there are 0 and can never trigger the height-gap rule. Returns
    (window (tail,), valid (tail,) bool).
    """
    m = heights.shape[0]
    if m < tail:  # tiny problems: pad so the window always exists
        heights = jnp.concatenate(
            [heights, jnp.zeros((tail - m,), heights.dtype)]
        )
        m = tail
    start = jnp.clip(n_real - 1 - tail, 0, max(m - tail, 0))
    window = jax.lax.dynamic_slice(heights, (start,), (tail,))
    merge_idx = start + jnp.arange(tail)
    valid = merge_idx < n_real - 1
    nvalid = jnp.sum(valid.astype(jnp.int32))
    last_valid = window[jnp.maximum(nvalid - 1, 0)]
    return jnp.where(valid, window, last_valid), valid
