"""2-D visualization embedding (~ visualization_SHARP, R/visualization_SHARP.R:31).

Feature construction matches the reference (:46-60): the embedding input is
`[w * scale(x0), scale(viE)]` — the wMetaC vote matrix fused with the
ensemble-mean RP features; w >= 100 uses x0 only (+ jitter), w <= 0.01 viE
only. PCA reduces to 50 dims when wider (:65-69).

The reference then calls Rtsne's Barnes-Hut C++ t-SNE. Accelerator
replacement: an *exact* t-SNE whose inner loop is two (n, n) matmuls per
iteration — on matrix units, exact beats tree-based approximations up to the
~1e4-cell sizes the reference ever visualizes (it subsamples to ~1e4 for
plots, R/plot_markers.R:136-143); larger inputs are subsampled
proportionally per cluster.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from sharp_tpu.types import SharpResult


def _zscore_cols(M: np.ndarray) -> np.ndarray:
    mu = M.mean(axis=0, keepdims=True)
    sd = M.std(axis=0, ddof=1, keepdims=True)
    return (M - mu) / np.where(sd > 1e-12, sd, 1.0)


def _pca(M: np.ndarray, dim: int) -> np.ndarray:
    Mc = M - M.mean(axis=0, keepdims=True)
    _, _, Vt = np.linalg.svd(Mc, full_matrices=False)
    return Mc @ Vt[:dim].T


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _binary_search_sigmas(D2: jax.Array, perplexity: float, max_iter: int = 50):
    """Per-point conditional P with entropy == log(perplexity)."""
    n = D2.shape[0]
    target = jnp.log(perplexity)
    eye = jnp.eye(n, dtype=bool)

    def H_and_P(beta):
        logits = -D2 * beta[:, None]
        logits = jnp.where(eye, -jnp.inf, logits)
        P = jax.nn.softmax(logits, axis=1)
        H = -jnp.sum(jnp.where(P > 1e-12, P * jnp.log(P), 0.0), axis=1)
        return H, P

    def body(_, carry):
        lo, hi, beta = carry
        H, _ = H_and_P(beta)
        too_high = H > target  # entropy too high -> increase beta
        lo = jnp.where(too_high, beta, lo)
        hi = jnp.where(too_high, hi, beta)
        beta = jnp.where(
            jnp.isinf(hi), beta * 2.0, 0.5 * (lo + hi)
        )
        return lo, hi, beta

    beta0 = jnp.ones((n,))
    lo0 = jnp.zeros((n,))
    hi0 = jnp.full((n,), jnp.inf)
    _, _, beta = jax.lax.fori_loop(0, max_iter, body, (lo0, hi0, beta0))
    _, P = H_and_P(beta)
    return P


@functools.partial(jax.jit, static_argnames=("n_iter", "exaggeration_iters"))
def _tsne_exact(
    X: jax.Array,
    key: jax.Array,
    perplexity: float = 30.0,
    n_iter: int = 500,
    exaggeration_iters: int = 100,
    lr: float = 200.0,
) -> jax.Array:
    n = X.shape[0]
    sq = jnp.sum(X * X, axis=1)
    D2 = jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    Pc = _binary_search_sigmas(D2, perplexity)
    P = (Pc + Pc.T) / (2.0 * n)
    P = jnp.maximum(P, 1e-12)

    Y0 = 1e-4 * jax.random.normal(key, (n, 2))
    eye = jnp.eye(n, dtype=bool)

    def step(i, carry):
        Y, V = carry
        sqy = jnp.sum(Y * Y, axis=1)
        num = 1.0 / (1.0 + jnp.maximum(
            sqy[:, None] + sqy[None, :] - 2.0 * (Y @ Y.T), 0.0
        ))
        num = jnp.where(eye, 0.0, num)
        Q = jnp.maximum(num / jnp.sum(num), 1e-12)
        exag = jnp.where(i < exaggeration_iters, 12.0, 1.0)
        PQ = (P * exag - Q) * num
        grad = 4.0 * (jnp.diag(jnp.sum(PQ, axis=1)) - PQ) @ Y
        mom = jnp.where(i < exaggeration_iters, 0.5, 0.8)
        V = mom * V - lr * grad
        Y = Y + V
        Y = Y - jnp.mean(Y, axis=0, keepdims=True)
        return Y, V

    Y, _ = jax.lax.fori_loop(0, n_iter, step, (Y0, jnp.zeros((n, 2))))
    return Y


def visualization_embedding(
    y: Union[SharpResult, Tuple[np.ndarray, np.ndarray]],
    *,
    w: float = 2.0,
    perplexity: float = 30.0,
    n_iter: int = 500,
    seed: int = 10,
    max_cells: int = 10000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Embed the clustering result in 2-D.

    Returns (embedding (m, 2), cell_indices (m,)) — indices identify the
    subsample when n > max_cells (proportional per cluster, mirroring
    R/plot_markers.R:136-143).
    """
    if isinstance(y, SharpResult):
        x0, viE, labels = y.x0, y.viE, y.pred_clusters
    else:
        x0, viE = y
        labels = None
    if x0 is None and viE is None:
        raise ValueError("need x0 and/or viE (run sharp with forview=True)")

    parts = []
    if w >= 100 or viE is None:
        rng = np.random.default_rng(seed)
        parts.append(
            w * _zscore_cols(np.asarray(x0))
            + 1e-3 * rng.normal(size=np.asarray(x0).shape)
        )
    elif w <= 0.01 or x0 is None:
        parts.append(_zscore_cols(np.asarray(viE)))
    else:
        parts.append(w * _zscore_cols(np.asarray(x0)))
        parts.append(_zscore_cols(np.asarray(viE)))
    X = np.concatenate(parts, axis=1).astype(np.float32)
    # drop all-constant columns (z-score left them 0)
    keep = X.std(axis=0) > 0
    X = X[:, keep] if keep.any() else X

    n = X.shape[0]
    idx = np.arange(n)
    if n > max_cells:
        rng = np.random.default_rng(seed)
        if labels is not None:
            sel = []
            for c in np.unique(labels):
                ci = np.flatnonzero(labels == c)
                take = max(int(round(len(ci) / n * max_cells)), 1)
                sel.append(rng.choice(ci, min(take, len(ci)), replace=False))
            idx = np.sort(np.concatenate(sel))
        else:
            idx = np.sort(rng.choice(n, max_cells, replace=False))
        X = X[idx]

    if X.shape[1] > 50:
        X = _pca(X, 50)

    key = jax.random.PRNGKey(seed)
    emb = _tsne_exact(
        jnp.asarray(X), key, perplexity=perplexity, n_iter=n_iter
    )
    return np.asarray(emb), idx
