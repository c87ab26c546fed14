"""Pearson-correlation distance between cells, masked, as one matmul.

The reference's per-RP clustering distance is `1 - cor(t(mat))` on the
row-standardized projected matrix (R/get_opt_hclust.R:70-74): the distance
between two cells is 1 minus the Pearson correlation of their p-dim RP
feature vectors. That is one rank-p matmul: center+normalize each row to
unit L2 norm, then D = 1 - U U^T.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Distances >= _PAD_TIER are "structural" padding values used by the linkage
# so padded points merge among themselves after all real merges. See
# sharp_tpu/ops/linkage.py.
PAD_PAD_DIST = 1e20   # padded point <-> padded point
PAD_REAL_DIST = 1e26  # padded point <-> real point
BIG = 1e30            # invalid / self entries for argmin masking


def standardize_rows(X: jax.Array, mask=None, eps: float = 1e-12) -> jax.Array:
    """Row-wise z-score (the reference's `t(scale(t(mat)))`, R/get_opt_hclust.R:71).

    Uses the sample std (ddof=1) to match R's `scale`. Rows flagged off by
    `mask` (n,) are zeroed.
    """
    p = X.shape[-1]
    mu = jnp.mean(X, axis=-1, keepdims=True)
    Xc = X - mu
    var = jnp.sum(Xc * Xc, axis=-1, keepdims=True) / jnp.maximum(p - 1, 1)
    Z = Xc * jax.lax.rsqrt(var + eps)
    if mask is not None:
        Z = jnp.where(mask[..., :, None], Z, 0.0)
    return Z


def _unit_rows(X: jax.Array, eps: float = 1e-12) -> jax.Array:
    mu = jnp.mean(X, axis=-1, keepdims=True)
    Xc = X - mu
    nrm = jnp.sum(Xc * Xc, axis=-1, keepdims=True)
    return Xc * jax.lax.rsqrt(nrm + eps)


@functools.partial(jax.jit, static_argnames=())
def pearson_distance(X: jax.Array, mask: jax.Array) -> jax.Array:
    """Masked pairwise 1 - Pearson(x_i, x_j) for rows of X (..., n, p).

    Returns (..., n, n) with:
      real-real   : 1 - corr  (in [0, 2])
      pad-pad     : PAD_PAD_DIST   (merge among themselves, late)
      pad-real    : PAD_REAL_DIST  (merge with real clusters last)
      diagonal    : 0
    `mask` (..., n) flags real cells. One matmul; everything else is
    elementwise.
    """
    U = _unit_rows(X)
    # HIGHEST precision: a reduced-precision matmul (bf16 passes, TF32)
    # rounds the unit rows, which can push 1 - corr slightly NEGATIVE for
    # near-identical cells. Negative distances violate the Ward
    # monotonicity the merge-replay height sort depends on (replay
    # violations, garbage clusters).
    corr = jnp.matmul(
        U, jnp.swapaxes(U, -1, -2),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    D = jnp.maximum(1.0 - corr, 0.0)
    m = mask.astype(bool)
    mi = m[..., :, None]
    mj = m[..., None, :]
    D = jnp.where(mi & mj, D, jnp.where(~mi & ~mj, PAD_PAD_DIST, PAD_REAL_DIST))
    n = D.shape[-1]
    eye = jnp.eye(n, dtype=bool)
    return jnp.where(eye, 0.0, D)


def similarity_to_distance(S: jax.Array, mask: jax.Array) -> jax.Array:
    """d = 1 - S for a symmetric similarity matrix (R/get_opt_hclust.R:66-69),
    with the same structural padding tiers as `pearson_distance`."""
    D = 1.0 - S
    m = mask.astype(bool)
    mi = m[..., :, None]
    mj = m[..., None, :]
    D = jnp.where(mi & mj, D, jnp.where(~mi & ~mj, PAD_PAD_DIST, PAD_REAL_DIST))
    n = D.shape[-1]
    eye = jnp.eye(n, dtype=bool)
    return jnp.where(eye, 0.0, D)
