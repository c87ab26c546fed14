"""Marker-gene identification — batched rank statistics on the device.

Equivalent of the reference's per-gene parallel loop
(R/get_marker_genes.R:25-261): per gene, nonzero fraction; rank expression
across cells; candidate cluster(s) by top mean rank; AUROC; Wilcoxon
rank-sum p; fold change vs the best other cluster; then Holm adjustment,
an *adaptive* AUC threshold so every cluster keeps at least one marker
(:212-219), filtering and sorting (:223-236).

Design: genes are processed in fixed-size chunks; the per-gene
rank vector comes from one vmapped sort+searchsorted; per-cluster mean
ranks / means are one-hot matmuls; AUROC is the closed rank form
AUC = U/(n1*n2) (ROCR's empirical AUROC equals this exactly), and the
Wilcoxon p uses the tie-corrected normal approximation with continuity
correction (R wilcox.test's large-sample path).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from sharp_tpu.types import SharpResult


@dataclasses.dataclass
class MarkerResult:
    mginfo: dict          # filtered marker table: arrays keyed by column
    gallinfo: dict        # per-gene stats for every tested gene
    mat: np.ndarray       # marker-gene expression rows (markers x cells)
    label: np.ndarray     # cluster labels used
    adauc: float          # adaptive AUC threshold actually applied

    @property
    def n_markers(self) -> int:
        return len(self.mginfo["gene"])


def _avg_ranks(x: jax.Array) -> jax.Array:
    """Average ranks with ties, R rank() semantics, for one vector."""
    xs = jnp.sort(x)
    lo = jnp.searchsorted(xs, x, side="left")
    hi = jnp.searchsorted(xs, x, side="right")
    return 0.5 * (lo + hi + 1.0)


@functools.partial(jax.jit, static_argnames=("C", "ng"))
def _gene_chunk_stats(
    Xg: jax.Array, oh: jax.Array, counts: jax.Array, *, C: int, ng: int = 1
):
    """Per-gene stats for a (n, G) chunk against (n, C) one-hot labels.

    `ng` = number of candidate clusters considered per gene: the top-ng
    by mean rank, keeping the one with the best AUROC
    (R/get_marker_genes.R:135-144; the gene-partitioned variant uses
    ng = min(10, C), R/get_marker_genes_unlimited2.R:184,229).

    Returns dp, best cluster, auc, z (signed Wilcoxon z), fc  — all (G,).
    """
    n = Xg.shape[0]
    nf = jnp.asarray(n, jnp.float32)
    dp = jnp.mean((Xg > 0).astype(jnp.float32), axis=0)

    ranks = jax.vmap(_avg_ranks, in_axes=1, out_axes=1)(Xg)     # (n, G)
    rank_sums = jnp.dot(oh.T, ranks, preferred_element_type=jnp.float32)  # (C, G)
    mean_ranks = rank_sums / jnp.maximum(counts[:, None], 1.0)

    # AUROC closed form for EVERY cluster (one elementwise pass over the
    # (C, G) rank sums — the reference's per-candidate ROCR calls are
    # already amortized), then restrict to the top-ng mean-rank candidates
    U_all = rank_sums - (counts * (counts + 1.0) / 2.0)[:, None]
    auc_all = U_all / jnp.maximum((counts * (nf - counts))[:, None], 1.0)
    if ng >= C:
        cand = jnp.ones_like(auc_all, dtype=bool)
    elif ng == 1:
        cand = mean_ranks == jnp.max(mean_ranks, axis=0, keepdims=True)
    else:
        kth = jnp.sort(mean_ranks, axis=0)[C - ng]               # (G,)
        cand = mean_ranks >= kth[None, :]
    best = jnp.argmax(
        jnp.where(cand, auc_all, -jnp.inf), axis=0
    )                                                            # (G,)

    n1 = counts[best]                                            # (G,)
    n2 = nf - n1
    rs1 = jnp.take_along_axis(rank_sums, best[None, :], axis=0)[0]
    U = rs1 - n1 * (n1 + 1.0) / 2.0
    auc = U / jnp.maximum(n1 * n2, 1.0)

    # tie correction: per-element group sizes from the same searchsorted
    def tiesum(x):
        xs = jnp.sort(x)
        lo = jnp.searchsorted(xs, x, side="left")
        hi = jnp.searchsorted(xs, x, side="right")
        g = (hi - lo).astype(jnp.float32)
        return jnp.sum(g * g - 1.0)

    ts = jax.vmap(tiesum, in_axes=1)(Xg)                         # (G,)
    sigma2 = (n1 * n2 / 12.0) * ((nf + 1.0) - ts / (nf * (nf - 1.0)))
    sigma = jnp.sqrt(jnp.maximum(sigma2, 1e-12))
    mu = n1 * n2 / 2.0
    diff = U - mu
    z = (diff - 0.5 * jnp.sign(diff)) / sigma                    # continuity corr.

    mean_expr = jnp.dot(oh.T, Xg, preferred_element_type=jnp.float32)
    mean_expr = mean_expr / jnp.maximum(counts[:, None], 1.0)    # (C, G)
    own_mean = jnp.take_along_axis(mean_expr, best[None, :], axis=0)[0]
    others = jnp.where(
        jnp.arange(C)[:, None] == best[None, :], -jnp.inf, mean_expr
    )
    best_other = jnp.max(others, axis=0)
    fc = own_mean / jnp.maximum(best_other, 1e-12)

    return dp, best.astype(jnp.int32), auc, z, fc


class _BlockedColumns:
    """Column-sliceable view over a list of row-blocks (cells split across
    blocks, genes shared) — lets the chunked kernel stream blocked data."""

    def __init__(self, blocks):
        self.blocks = [np.asarray(b) for b in blocks]
        g = {b.shape[1] for b in self.blocks}
        if len(g) != 1:
            raise ValueError("all blocks must share the gene dimension")
        self.shape = (sum(b.shape[0] for b in self.blocks), g.pop())

    def __getitem__(self, key):
        rows, cols = key
        return np.concatenate([b[rows, cols] for b in self.blocks], axis=0)


def _holm(p: np.ndarray) -> np.ndarray:
    """Holm step-down adjustment (R p.adjust(method='holm'))."""
    m = len(p)
    order = np.argsort(p)
    adj = np.empty(m)
    running = 0.0
    for rank, idx in enumerate(order):
        running = max(running, (m - rank) * p[idx])
        adj[idx] = min(running, 1.0)
    return adj


def get_marker_genes(
    X,
    y: Union[SharpResult, np.ndarray, Sequence[int]],
    *,
    gene_names: Optional[Sequence[str]] = None,
    theta: float = 1e-4,
    auc_thre: float = 0.7,
    p_thre: float = 0.01,
    fc_thre: float = 2.0,
    chunk: int = 2048,
) -> MarkerResult:
    """Identify per-cluster marker genes (~ get_marker_genes,
    R/get_marker_genes.R:25). X is cells x genes — a single matrix, or a
    list of row-blocks (the blocked variants get_marker_genes_unlimited*,
    R/get_marker_genes_unlimited.R:25, are just more chunks here).
    `y` a SharpResult or a label vector. Defaults match the reference
    (:36-54)."""
    labels = np.asarray(
        y.pred_clusters if isinstance(y, SharpResult) else y
    )
    if isinstance(X, (list, tuple)):
        X = _BlockedColumns(X)
    n, D = X.shape
    uniq = np.unique(labels)
    C = len(uniq)
    enc = np.searchsorted(uniq, labels)
    oh = jnp.asarray(np.eye(C, dtype=np.float32)[enc])
    counts = jnp.asarray(np.bincount(enc, minlength=C).astype(np.float32))

    dp_l, best_l, auc_l, z_l, fc_l = [], [], [], [], []
    for start in range(0, D, chunk):
        Xg = jnp.asarray(
            np.ascontiguousarray(X[:, start : start + chunk], np.float32)
        )
        dp, best, auc, z, fc = _gene_chunk_stats(Xg, oh, counts, C=C)
        dp_l.append(np.asarray(dp))
        best_l.append(np.asarray(best))
        auc_l.append(np.asarray(auc))
        z_l.append(np.asarray(z))
        fc_l.append(np.asarray(fc))

    dp = np.concatenate(dp_l)
    best = np.concatenate(best_l)
    auc = np.concatenate(auc_l)
    z = np.concatenate(z_l)
    fc = np.concatenate(fc_l)

    gallinfo, mginfo, idx, adauc = _finish(
        dp, best, auc, z, fc, uniq, C,
        theta=theta, auc_thre=auc_thre, p_thre=p_thre, fc_thre=fc_thre,
        gene_names=gene_names,
    )
    mat = np.ascontiguousarray(X[:, idx].T, np.float32)
    return MarkerResult(
        mginfo=mginfo, gallinfo=gallinfo, mat=mat, label=labels, adauc=adauc
    )


def _finish(
    dp, best, auc, z, fc, uniq, C, *, theta, auc_thre, p_thre, fc_thre,
    gene_names,
):
    """Shared marker postprocessing: Holm adjustment, adaptive AUC
    threshold, filtering + per-cluster rescue, reference sort order.
    Returns (gallinfo, mginfo, selected gene indices, adauc)."""
    D = len(dp)
    from scipy.stats import norm

    pvals = 2.0 * norm.sf(np.abs(z))
    tested = dp > theta
    p_adj = np.ones(D)
    p_adj[tested] = _holm(pvals[tested])

    names = (
        np.asarray(gene_names)
        if gene_names is not None
        else np.array([f"g{i}" for i in range(D)])
    )
    gallinfo = {
        "gene": names,
        "gene_index": np.arange(D),
        "cluster": uniq[best],
        "sparsity": dp,
        "auc": auc,
        "pvalue": pvals,
        "p_adj": p_adj,
        "fold_change": fc,
        "tested": tested,
    }

    # adaptive AUC threshold: never let a cluster lose all its markers
    # (R/get_marker_genes.R:212-219)
    adauc = auc_thre
    for c in range(C):
        in_c = tested & (best == c)
        if in_c.any():
            adauc = min(adauc, auc[in_c].max())
    adauc = float(adauc)

    keep = tested & (p_adj < p_thre) & (auc >= adauc) & (fc >= fc_thre)
    # per-cluster rescue: clusters emptied by p/fc filters keep their best-AUC gene
    for c in range(C):
        if not (keep & (best == c)).any():
            in_c = tested & (best == c)
            if in_c.any():
                gidx = np.flatnonzero(in_c)[np.argmax(auc[in_c])]
                keep[gidx] = True

    idx = np.flatnonzero(keep)
    order = np.lexsort(
        (dp[idx] * -1, pvals[idx], -auc[idx], -fc[idx], uniq[best[idx]])
    )
    idx = idx[order]
    mginfo = {k: v[idx] for k, v in gallinfo.items() if k != "tested"}
    return gallinfo, mginfo, idx, adauc


def get_marker_genes_unlimited2(
    gene_blocks,
    y: Union[SharpResult, np.ndarray, Sequence[int]],
    *,
    gene_names: Optional[Sequence[str]] = None,
    theta: float = 1e-5,
    auc_thre: float = 0.85,
    p_thre: float = 0.05,
    fc_thre: float = 2.0,
    ng: Optional[int] = None,
    chunk: int = 2048,
) -> MarkerResult:
    """Marker genes from GENE-PARTITIONED input (~ get_marker_genes_unlimited2,
    R/get_marker_genes_unlimited2.R:25).

    `gene_blocks` is a directory of stored files, or a list of arrays /
    file paths — each holding ALL cells x a slice of the genes (the
    transpose of the cell-blocked layout: here genes are split across
    files, cells are shared). Files are visited one at a time in numeric
    filename order (R :159-162); only per-gene scalar stats are kept in
    memory, so the full genes axis never has to fit at once.

    Defaults follow the reference variant (R :36-46): stricter
    sparsity/AUC/p thresholds (theta=1e-5, AUC=0.85, p=0.05) and
    candidate clusters = the top min(10, C) mean ranks (R :184,229),
    keeping the candidate with the best AUROC.
    """
    import os

    labels = np.asarray(
        y.pred_clusters if isinstance(y, SharpResult) else y
    )
    uniq = np.unique(labels)
    C = len(uniq)
    enc = np.searchsorted(uniq, labels)
    oh = jnp.asarray(np.eye(C, dtype=np.float32)[enc])
    counts = jnp.asarray(np.bincount(enc, minlength=C).astype(np.float32))
    ng_eff = min(10, C) if ng is None else min(ng, C)

    # resolve input form -> a loader per gene-block
    if isinstance(gene_blocks, str):
        from sharp_tpu.io.blocks import BlockStore

        files = BlockStore(gene_blocks).files()
        loaders = [lambda f=f: BlockStore.load(f) for f in files]
    else:
        loaders = []
        for b in gene_blocks:
            if isinstance(b, str):
                from sharp_tpu.io.blocks import BlockStore

                loaders.append(lambda f=b: BlockStore.load(f))
            else:
                loaders.append(lambda a=b: np.asarray(a, np.float32))

    dp_l, best_l, auc_l, z_l, fc_l = [], [], [], [], []
    block_cols = []
    for load in loaders:
        Xb = load()
        if Xb.shape[0] != len(labels):
            raise ValueError(
                f"gene block has {Xb.shape[0]} cells, labels have "
                f"{len(labels)} — gene-partitioned blocks must share the "
                "cell axis"
            )
        block_cols.append(Xb.shape[1])
        for start in range(0, Xb.shape[1], chunk):
            Xg = jnp.asarray(
                np.ascontiguousarray(Xb[:, start : start + chunk], np.float32)
            )
            dp, best, auc, z, fc = _gene_chunk_stats(
                Xg, oh, counts, C=C, ng=ng_eff
            )
            dp_l.append(np.asarray(dp))
            best_l.append(np.asarray(best))
            auc_l.append(np.asarray(auc))
            z_l.append(np.asarray(z))
            fc_l.append(np.asarray(fc))
        del Xb

    dp = np.concatenate(dp_l)
    best = np.concatenate(best_l)
    auc = np.concatenate(auc_l)
    z = np.concatenate(z_l)
    fc = np.concatenate(fc_l)

    gallinfo, mginfo, idx, adauc = _finish(
        dp, best, auc, z, fc, uniq, C,
        theta=theta, auc_thre=auc_thre, p_thre=p_thre, fc_thre=fc_thre,
        gene_names=gene_names,
    )

    # marker expression rows: revisit only the files holding selected genes
    offsets = np.concatenate([[0], np.cumsum(block_cols)])
    mat = np.zeros((len(idx), len(labels)), np.float32)
    pos_of = {int(g): i for i, g in enumerate(idx)}
    for bi, load in enumerate(loaders):
        lo, hi = offsets[bi], offsets[bi + 1]
        local = [g for g in idx if lo <= g < hi]
        if not local:
            continue
        Xb = load()
        for g in local:
            mat[pos_of[int(g)]] = Xb[:, int(g - lo)]
        del Xb

    return MarkerResult(
        mginfo=mginfo, gallinfo=gallinfo, mat=mat, label=labels, adauc=adauc
    )
