"""Batched silhouette and Calinski-Harabasz over candidate cluster counts.

The reference loops k = 2..40 calling `cluster::silhouette` and
`clues::get_CH` per cut on the same n x n distance matrix
(R/get_opt_hclust.R:129-154). Here every candidate cut is evaluated in one
batch: per-cell-per-cluster distance sums are a single (n, n) x (n, nc_pad)
matmul per candidate, vmapped over the candidate axis; the distance
matrix is computed once and reused.

Conventions matched to the reference:
  * silhouette summary = *median* of per-cell widths (R/get_opt_hclust.R:137)
  * singleton clusters get width 0 (cluster::silhouette convention)
  * CH follows clues::get_CH's "1-corr" variant: between/within dispersions
    measured as (1 - Pearson) of points/centroids to their means
    (R/get_opt_hclust.R:144). clues is an archived CRAN package; the
    closed-form here is the standard CH generalization with that distance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Exact matmuls throughout: counts are integers and distance sums feed
# argmax selection decisions; a reduced-precision matmul (bf16 passes,
# TF32) rounds f32 operands.
_HI = jax.lax.Precision.HIGHEST

# numpy scalar, NOT jnp.float32(...): calling a jnp scalar type creates a
# device array at import time, initializing the XLA backend and locking
# out jax.distributed.initialize for multihost runs
import numpy as _np

_INF = _np.float32(_np.inf)


def masked_median(x: jax.Array, mask: jax.Array, n_valid: jax.Array) -> jax.Array:
    """Median of x over entries where mask, R-style (mean of two middles)."""
    xs = jnp.sort(jnp.where(mask, x, _INF))
    lo = xs[jnp.maximum((n_valid - 1) // 2, 0)]
    hi = xs[jnp.maximum(n_valid // 2, 0)]
    return 0.5 * (lo + hi)


def _onehot(labels: jax.Array, real_mask: jax.Array, nc_pad: int) -> jax.Array:
    oh = jax.nn.one_hot(labels, nc_pad, dtype=jnp.float32)
    return oh * real_mask[:, None].astype(jnp.float32)


def silhouette_median(
    D_real: jax.Array,
    labels: jax.Array,
    real_mask: jax.Array,
    n_real: jax.Array,
    nc_pad: int,
) -> jax.Array:
    """Median silhouette width of one labelling.

    D_real: (n, n) with pad rows/cols zeroed and zero diagonal.
    labels: (n,) dense ids in [0, k); padded cells at nc_pad-1.
    """
    oh = _onehot(labels, real_mask, nc_pad)          # (n, nc_pad)
    counts = jnp.sum(oh, axis=0)                      # (nc_pad,)
    sums = jnp.dot(D_real, oh, preferred_element_type=jnp.float32, precision=_HI)  # (n, nc_pad)

    # own-cluster selections as one-hot contractions instead of row
    # gathers
    own = labels
    own_count = jnp.sum(oh * counts[None, :], axis=1)
    own_sum = jnp.sum(oh * sums, axis=1)
    a = own_sum / jnp.maximum(own_count - 1.0, 1.0)

    mean_other = sums / jnp.maximum(counts[None, :], 1.0)
    # exclude own cluster, empty clusters, and the garbage pad slot
    slot = jnp.arange(nc_pad)[None, :]
    excl = (slot == own[:, None]) | (counts[None, :] < 0.5) | (slot == nc_pad - 1)
    b = jnp.min(jnp.where(excl, _INF, mean_other), axis=1)

    s = (b - a) / jnp.maximum(jnp.maximum(a, b), 1e-12)
    s = jnp.where(own_count <= 1.5, 0.0, s)           # singleton convention
    s = jnp.where(jnp.isfinite(b), s, 0.0)            # k == 1 edge
    return masked_median(s, real_mask, n_real)


def ch_index(
    feats_unit: jax.Array,
    labels: jax.Array,
    real_mask: jax.Array,
    n_real: jax.Array,
    k: jax.Array,
    nc_pad: int,
) -> jax.Array:
    """Calinski-Harabasz with 1-corr dispersion (clues::get_CH semantics).

    feats_unit: (n, p) rows centered+unit-normalized (so corr = dot).
    """
    rm = real_mask.astype(jnp.float32)
    oh = _onehot(labels, real_mask, nc_pad)           # (n, nc_pad)
    counts = jnp.sum(oh, axis=0)
    cent = jnp.dot(oh.T, feats_unit, preferred_element_type=jnp.float32, precision=_HI)
    cent = cent / jnp.maximum(counts[:, None], 1.0)   # (nc_pad, p)

    def unit(v):
        mu = jnp.mean(v, axis=-1, keepdims=True)
        vc = v - mu
        return vc * jax.lax.rsqrt(jnp.sum(vc * vc, axis=-1, keepdims=True) + 1e-12)

    cent_u = unit(cent)
    # within: sum over cells of (1 - corr(x_i, centroid_own)); the row
    # gather cent_u[labels] becomes a (n, p) x (p, nc) matmul + one-hot
    # select
    fc = jnp.dot(feats_unit, cent_u.T, preferred_element_type=jnp.float32, precision=_HI)
    corr_own = jnp.sum(oh * fc, axis=-1)
    W = jnp.sum(jnp.where(real_mask, 1.0 - corr_own, 0.0))
    # between: sum over clusters of n_c * (1 - corr(centroid_c, global mean))
    g = jnp.sum(feats_unit * rm[:, None], axis=0) / jnp.maximum(n_real, 1)
    g_u = unit(g[None, :])[0]
    corr_cg = jnp.sum(cent_u * g_u[None, :], axis=-1)
    slot_valid = (counts > 0.5) & (jnp.arange(nc_pad) != nc_pad - 1)
    B = jnp.sum(jnp.where(slot_valid, counts * (1.0 - corr_cg), 0.0))

    denom_ok = (k > 1) & (n_real > k)
    ch = (B / jnp.maximum(k - 1.0, 1.0)) / jnp.maximum(
        W / jnp.maximum(n_real - k.astype(jnp.float32), 1.0), 1e-12
    )
    return jnp.where(denom_ok, ch, 0.0)


@functools.partial(jax.jit, static_argnames=("minN", "ncand", "nc_pad"))
def sweep_scores_nested(
    D_real: jax.Array,       # (n, n) pad rows/cols zeroed, zero diagonal
    feats_unit: jax.Array,   # (n, p) centered unit rows
    merges: jax.Array,       # (n_pad - 1, 2) linkage merge sequence
    labels_all: jax.Array,   # (ncand, n) dense per-cut labels (cutree)
    real_mask: jax.Array,
    n_real: jax.Array,
    maxN: jax.Array,
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
):
    """Median silhouette + CH for every candidate cut, exploiting cut
    nesting.

    Candidate cuts k = minN..minN+ncand-1 are nested — cut k's clusters
    are cut k+1's with one pair merged — so the distinct clusters across
    the whole sweep are the <= nc_pad clusters of the finest cut plus one
    new node per coarser cut. Per-cluster distance sums (the silhouette
    workhorse, reference R/get_opt_hclust.R:129-154 recomputes them per
    k) are therefore ONE (n, n) x (n, V) matmul plus ncand column
    additions, V = nc_pad + ncand, instead of ncand full matmuls — the
    difference between seconds and minutes at sMetaC scale (thousands of
    fold-clusters, hundreds of candidates at >= 1e6 cells,
    R/sMetaC.R:103-119).

    Matches `sweep_scores` up to fp association.
    """
    n = D_real.shape[0]
    V = nc_pad + ncand
    rm = real_mask.astype(jnp.float32)

    # nc_pad - 1 caps representable cuts: k clusters need dense ids
    # 0..k-1 clear of the reserved garbage slot nc_pad - 1
    kmax_eff = jnp.minimum(
        jnp.minimum(jnp.minimum(maxN, n_real - 1), minN + ncand - 1),
        nc_pad - 1,
    )
    c_fine = jnp.clip(kmax_eff - minN, 0, ncand - 1).astype(jnp.int32)
    own_fine = labels_all[c_fine]                  # (n,) in [0, nc_pad)
    oh_fine = jax.nn.one_hot(own_fine, V, dtype=jnp.float32) * rm[:, None]
    counts0 = jnp.sum(oh_fine, axis=0)             # (V,)
    sums0 = jnp.dot(D_real, oh_fine, preferred_element_type=jnp.float32, precision=_HI)
    centsum0 = jnp.dot(
        oh_fine.T, feats_unit, preferred_element_type=jnp.float32, precision=_HI
    )                                              # (V, p)
    alive0 = counts0 > 0.5

    colv = jnp.arange(V)

    def build(carry, c):
        own, sums, counts, centsum, alive = carry
        k = minN + c
        apply = c < c_fine
        t = jnp.clip(n_real - k - 1, 0, merges.shape[0] - 1)
        i = merges[t, 0]
        j = merges[t, 1]
        coli = own[i]
        colj = own[j]
        newslot = nc_pad + c
        ohi = (colv == coli).astype(jnp.float32)
        ohj = (colv == colj).astype(jnp.float32)
        sel = ohi + ohj                            # (V,)
        new_sum = jnp.dot(sums, sel, preferred_element_type=jnp.float32, precision=_HI)
        new_count = jnp.dot(counts, sel, preferred_element_type=jnp.float32, precision=_HI)
        new_cent = jnp.dot(sel, centsum, preferred_element_type=jnp.float32, precision=_HI)
        at_new = colv == newslot
        sums = jnp.where(
            apply & at_new[None, :], new_sum[:, None], sums
        )
        counts = jnp.where(apply & at_new, new_count, counts)
        centsum = jnp.where(
            apply & at_new[:, None], new_cent[None, :], centsum
        )
        own = jnp.where(
            apply & ((own == coli) | (own == colj)), newslot, own
        )
        alive = jnp.where(
            apply, (alive & (colv != coli) & (colv != colj)) | at_new, alive
        )
        return (own, sums, counts, centsum, alive), (own, alive)

    (own_f, sums, counts, centsum, alive_f), (own_all, alive_all) = (
        jax.lax.scan(
            build,
            (own_fine, sums0, counts0, centsum0, alive0),
            jnp.arange(ncand - 1, -1, -1),
        )
    )
    # scan emitted in c = ncand-1..0 order; consumers index it reversed
    # (an array flip would lower to an n-sized gather)

    # cut-independent node quantities
    def unit(v):
        mu = jnp.mean(v, axis=-1, keepdims=True)
        vc = v - mu
        return vc * jax.lax.rsqrt(
            jnp.sum(vc * vc, axis=-1, keepdims=True) + 1e-12
        )

    cent_u = unit(centsum / jnp.maximum(counts[:, None], 1.0))  # (V, p)
    FC = jnp.dot(feats_unit, cent_u.T, preferred_element_type=jnp.float32, precision=_HI)
    g = jnp.sum(feats_unit * rm[:, None], axis=0) / jnp.maximum(n_real, 1)
    g_u = unit(g[None, :])[0]
    corr_cg = jnp.sum(cent_u * g_u[None, :], axis=-1)           # (V,)
    mean_node = sums / jnp.maximum(counts, 1.0)[None, :]        # (n, V)
    nodes_ok = counts > 0.5

    def score(c):
        own = own_all[ncand - 1 - c]
        alive = alive_all[ncand - 1 - c]
        oh = jax.nn.one_hot(own, V, dtype=jnp.float32) * rm[:, None]
        own_sum = jnp.sum(oh * sums, axis=1)
        own_count = jnp.sum(oh * counts[None, :], axis=1)
        a = own_sum / jnp.maximum(own_count - 1.0, 1.0)
        excl = ~alive[None, :] | (oh > 0.5) | ~nodes_ok[None, :]
        b = jnp.min(jnp.where(excl, _INF, mean_node), axis=1)
        s = (b - a) / jnp.maximum(jnp.maximum(a, b), 1e-12)
        s = jnp.where(own_count <= 1.5, 0.0, s)
        s = jnp.where(jnp.isfinite(b), s, 0.0)

        corr_own = jnp.sum(oh * FC, axis=1)
        W = jnp.sum(jnp.where(real_mask, 1.0 - corr_own, 0.0))
        Bv = jnp.sum(
            jnp.where(alive & nodes_ok, counts * (1.0 - corr_cg), 0.0)
        )
        k = jnp.asarray(minN + c, jnp.float32)
        denom_ok = (k > 1) & (n_real > k)
        ch = (Bv / jnp.maximum(k - 1.0, 1.0)) / jnp.maximum(
            W / jnp.maximum(n_real - k, 1.0), 1e-12
        )
        return s, jnp.where(denom_ok, ch, 0.0)

    # chunked map (sequential-iteration overhead dominates otherwise);
    # medians batched into one sort over the cut axis
    s_all, ch = jax.lax.map(
        score, jnp.arange(ncand), batch_size=min(8, ncand)
    )
    msil = jax.vmap(lambda s: masked_median(s, real_mask, n_real))(s_all)
    return msil, ch


@functools.partial(jax.jit, static_argnames=("nc_pad",))
def sweep_scores(
    D_real: jax.Array,
    feats_unit: jax.Array,
    labels_all: jax.Array,   # (ncand, n)
    ks: jax.Array,           # (ncand,)
    real_mask: jax.Array,
    n_real: jax.Array,
    *,
    nc_pad: int,
):
    """Median silhouette + CH for every candidate cut. Returns (msil, ch)."""
    def one(labels, k):
        msil = silhouette_median(D_real, labels, real_mask, n_real, nc_pad)
        ch = ch_index(feats_unit, labels, real_mask, n_real, k, nc_pad)
        return msil, ch

    return jax.vmap(one)(labels_all, ks)
