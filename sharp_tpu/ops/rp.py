"""Very-sparse ternary random projection as one dense device matmul.

Semantics follow Achlioptas/Li as used by the reference (R/ranM.R:17-30):
entries of the m x p projection matrix are {+sqrt(s), 0, -sqrt(s)} with
probabilities {1/(2s), 1 - 1/s, 1/(2s)}, s = sqrt(m)  (expected density
1/sqrt(m), ~0.6% at 28k genes), and the projection is scaled by 1/sqrt(p)
(R/RPmat.R:32: `projmat = 1/sqrt(p) * t(R) %*% scdata`).

Design decisions (vs the reference's sparse `Matrix` path):
  * The RP matrix is *generated on device from a PRNGKey* and kept dense —
    at ~0.6% density a 28k x 256 matrix is still only ~14 MB bf16, and a
    dense matmul beats any gather-based sparse trick at these sizes.
    Deterministic regeneration from the key replaces the reference's
    broadcast of shared `rM` into forked workers (R/SHARP.R:541-549).
  * All K ensemble members are concatenated to a single (m, K*p) operand so
    each cell block is read from device memory exactly once per projection pass.
  * The optional log2(1+x) transform (R/SHARP.R:343-345) is fused into the
    matmul input — XLA folds the elementwise op into the matmul operand.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sharp_tpu.utils.prng import member_key


def ternary_rp_matrix(key: jax.Array, m: int, p: int, dtype=jnp.float32) -> jax.Array:
    """Sample an (m, p) ternary very-sparse RP matrix on device.

    Entries: +/- sqrt(s) w.p. 1/(2s) each, 0 otherwise, s = sqrt(m)
    (R/ranM.R:17-24). E[r^2] = 1, so 1/sqrt(p) * R^T x preserves distances.
    """
    s = jnp.sqrt(jnp.asarray(m, jnp.float32))
    root_s = jnp.sqrt(s)
    u = jax.random.uniform(key, (m, p), dtype=jnp.float32)
    thresh = 1.0 / (2.0 * s)
    r = jnp.where(u < thresh, root_s, jnp.where(u > 1.0 - thresh, -root_s, 0.0))
    return r.astype(dtype)


def ensemble_rp_matrix(
    key: jax.Array, K: int, m: int, p: int, dtype=jnp.float32
) -> jax.Array:
    """All K ensemble RP matrices stacked to (m, K*p).

    Shared across all cell blocks/folds — the cross-block comparability
    requirement of sMetaC's shared RP feature space (R/SHARP.R:541-549,
    R/SHARP_unlimited.R:96-105).
    """
    cols = [ternary_rp_matrix(member_key(key, k), m, p, dtype) for k in range(K)]
    return jnp.concatenate(cols, axis=1)


@functools.partial(jax.jit, static_argnames=("log_transform",))
def rp_project(
    X: jax.Array, R: jax.Array, *, log_transform: bool = False
) -> jax.Array:
    """Project cells-by-genes X (n, m) with RP matrix R (m, p) -> (n, p).

    Equivalent to the reference's `1/sqrt(p) * t(R) %*% E` on log2(E+1)
    (R/SHARP.R:579, R/RPmat.R:32) but laid out cells-as-rows so the matmul
    contracts the gene axis.
    """
    p = R.shape[1]
    Xc = jnp.log2(1.0 + X) if log_transform else X
    out = jnp.dot(Xc.astype(R.dtype), R, preferred_element_type=jnp.float32)
    return out * jax.lax.rsqrt(jnp.asarray(p, jnp.float32))


@functools.partial(jax.jit, static_argnames=("K", "log_transform"))
def rp_project_ensemble(
    X: jax.Array, R_all: jax.Array, *, K: int, log_transform: bool = False
) -> jax.Array:
    """Project X (n, m) with the stacked (m, K*p) ensemble -> (K, n, p).

    One matmul for the whole ensemble: X is streamed from device memory
    once.
    """
    n = X.shape[0]
    Kp = R_all.shape[1]
    p = Kp // K
    Xc = jnp.log2(1.0 + X) if log_transform else X
    out = jnp.dot(Xc.astype(R_all.dtype), R_all, preferred_element_type=jnp.float32)
    out = out * jax.lax.rsqrt(jnp.asarray(p, jnp.float32))
    return jnp.transpose(out.reshape(n, K, p), (1, 0, 2))
