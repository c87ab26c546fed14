"""SHARP large-data path: fold partitioning + per-fold ensemble +
per-fold wMetaC + global sMetaC.

Mirrors SHARP_large (R/SHARP.R:478-851): random cell reshuffle (skipped at
>= 1e5 cells, :493-507), ~partition.ncells folds with last-two-fold
rebalancing (:513-536), K shared RP matrices (:541-549), per-(k,t)
project+cluster (:554-618), per-fold wMetaC (:692-731), cross-fold sMetaC
over centroids in mean-RP space (:747-773), un-permute + tiny-cluster
merge + relabel (:775-843).

Structure: the reference's K x T `foreach` fork fan-out becomes
a vmap over K inside one jitted block program, iterated (or sharded, see
sharp_tpu/parallel) over folds; cross-fold communication is exactly the
per-fold summary tensors (labels, centroid stats, mean-RP features) —
O(clusters x p), never O(cells^2).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sharp_tpu.config import SharpConfig, pad_dim
from sharp_tpu.core.smetac import smetac, smetac_range
from sharp_tpu.core.pipeline import resolve_log_transform
from sharp_tpu.ops.rp import ensemble_rp_matrix
from sharp_tpu.types import SharpResult, finalize_labels
from sharp_tpu.utils.prng import shuffle_key
from sharp_tpu.utils.timers import StageTimer, log


def fold_sizes(n: int, partition_ncells: int) -> List[int]:
    """Fold partition with last-two-fold rebalancing (R/SHARP.R:513-536)."""
    if n <= partition_ncells:
        return [n]
    T = int(np.ceil(n / partition_ncells))
    sizes = [partition_ncells] * (T - 1)
    rem = n - partition_ncells * (T - 1)
    if T >= 2 and rem < partition_ncells:
        tot = partition_ncells + rem
        half = tot // 2
        sizes = sizes[:-1] + [tot - half, half]
    else:
        sizes = sizes + [rem]
    assert sum(sizes) == n
    return sizes


def summary_to_host(s, n_fold: int, forview: bool = True) -> dict:
    """Device FoldSummary -> host dict, truncated to real cells.

    `forview=False` skips the mean_proj / x0 planes — the only O(B x p)
    payloads — cutting the device->host traffic per fold from ~2.5 MB to
    ~60 KB. The clustering path needs only the O(clusters x p) summary.
    """
    out = {
        "finalC": np.asarray(s.finalC)[:n_fold],
        "n_meta": int(s.n_meta),
        "cent_sum": np.asarray(s.cent_sum),
        "counts": np.asarray(s.counts),
        "k_per": np.asarray(s.k_per),
        "maxsil": np.asarray(s.maxsil),
        "overflow": bool(np.asarray(s.overflow)),
    }
    if forview:
        out["mean_proj"] = np.asarray(s.mean_proj)[:n_fold]
        out["x0"] = np.asarray(s.x0)[:n_fold]
    return out


_SUMMARY_FIELDS = (
    "finalC", "n_meta", "cent_sum", "counts", "k_per", "maxsil", "overflow"
)


def summaries_to_host(out, sizes, forview: bool):
    """Batched device FoldSummary -> per-fold host dicts, ONE selective
    bulk pull per field.

    Two device-to-host pathologies this avoids (both measured on a
    high-latency device link):
    per-fold tree.map(a[gi]) slicing launches ~7 tiny device programs +
    pulls PER FOLD, and a whole-tree bulk pull
    drags the (G, B, p) mean_proj / (G, B, nc_pad) x0 planes (~40 MB per
    group) that forview=False discards anyway.
    """
    names = _SUMMARY_FIELDS + (("mean_proj", "x0") if forview else ())
    host = {k: np.asarray(getattr(out, k)) for k in names}
    res = []
    for gi, sz in enumerate(sizes):
        sz = int(sz)
        fr = {
            "finalC": host["finalC"][gi][:sz],
            "n_meta": int(host["n_meta"][gi]),
            "cent_sum": host["cent_sum"][gi],
            "counts": host["counts"][gi],
            "k_per": host["k_per"][gi],
            "maxsil": host["maxsil"][gi],
            "overflow": bool(host["overflow"][gi]),
        }
        if forview:
            fr["mean_proj"] = host["mean_proj"][gi][:sz]
            fr["x0"] = host["x0"][gi][:sz]
        res.append(fr)
    return res


def process_fold(
    X_fold: np.ndarray,
    n_fold: int,
    block_pad: int,
    R_all,
    cfg: SharpConfig,
    logf: bool,
):
    """One fold: ensemble cluster + wMetaC. Returns per-fold summaries."""
    from sharp_tpu.core.fold import fold_program, fold_static_args

    genes = X_fold.shape[1]
    Xp = np.zeros((block_pad, genes), np.float32)
    Xp[:n_fold] = X_fold
    mask = np.zeros(block_pad, bool)
    mask[:n_fold] = True

    st = fold_static_args(cfg)
    s = fold_program(
        jnp.asarray(Xp), jnp.asarray(mask), jnp.asarray(n_fold), R_all,
        jnp.asarray(logf),
        (jnp.asarray(cfg.indN_cluster) if cfg.indN_cluster is not None else None),
        has_indN=cfg.indN_cluster is not None,
        **st,
    )
    return summary_to_host(s, n_fold, forview=cfg.forview)


class FuseResult(NamedTuple):
    """Result of the cross-fold sMetaC fuse.

    Width invariant (uniform across fold counts): `labels` index the
    columns of `x0`/rows of `cents`, and the LAST slot (W - 1) is the
    reserved garbage slot — W is `meta_nc_pad` when T > 1 and the fold's
    `nc_pad` when T == 1 (the fold-local consensus IS the block meta
    clustering then).
    """

    labels: np.ndarray        # (n_total,) meta label per cell, fold order
    n_final: int
    x0: Optional[np.ndarray]  # (n_total, W) vis matrix; None when folds carry no x0
    cents: np.ndarray         # (W, p) per-meta-cluster centroid in mean-RP space
    counts: np.ndarray        # (W,) cells per meta cluster


class _PreparedBlock(NamedTuple):
    """Host-side compaction of one block's fold summaries for sMetaC."""

    t_idx: np.ndarray      # (NC,) fold index per global (fold, cluster) id
    c_idx: np.ndarray      # (NC,) fold-local cluster id
    cent_sums: np.ndarray  # (NC, p) per-cluster centroid SUMS
    counts: np.ndarray     # (NC,) cells per cluster
    cents: np.ndarray      # (NC, p) centroids (sums / counts)
    NC: int
    NC_pad: int
    minN: int
    maxN: int
    ncand: int
    meta_nc_pad: int


def _smetac_block_shapes(cfg: SharpConfig, NC: int, NC_pad: int):
    """Static sMetaC shapes for one block.

    `ncand`/`meta_nc_pad` are sized from the PADDED cluster-count budget
    (NC_pad), not the exact NC: candidates beyond the per-block traced
    maxN are invalid-masked inside opt_hclust (cutree_multi's `valid`),
    so selection is unchanged, while every block in the same NC_pad
    bucket shares one compiled smetac program (the round-2 bench paid a
    full XLA compile inside the timed fuse whenever blocks straddled a
    bucket boundary).
    """
    minN, eff_maxN = smetac_range(
        cfg.n_cells, cfg.minN_cluster, cfg.maxN_cluster, NC
    )
    maxN = min(eff_maxN, NC - 1) if NC > 1 else 1
    # a block with fewer clusters than the >= 1e6 widened minN floor
    # would otherwise have NO valid candidate and silently collapse to
    # one cluster (the reference's cutree would error outright here);
    # clamp the floor so at least one candidate survives
    if maxN < minN:
        minN = max(2, maxN)
    budget = min(eff_maxN, NC_pad)
    ncand = max(budget - minN + 1, 1)
    meta_nc_pad = ((budget + 9) // 8) * 8
    return minN, maxN, ncand, meta_nc_pad


def _prepare_block(
    fold_results: List[dict], cfg: SharpConfig, NC_pad: Optional[int] = None
) -> _PreparedBlock:
    """Compact nonzero (fold, cluster) slots into dense global ids.

    Entry order matches the original host loop: fold-major, cluster id
    ascending within a fold (np.nonzero row-major order).
    """
    nc_pad = cfg.nc_pad
    counts_all = np.stack(
        [fr["counts"][: nc_pad - 1] for fr in fold_results]
    )  # (T, nc_pad - 1)
    t_idx, c_idx = np.nonzero(counts_all > 0)
    NC = len(t_idx)
    cent_all = np.stack([fr["cent_sum"] for fr in fold_results])
    cent_sums = cent_all[t_idx, c_idx].astype(np.float32)
    counts = counts_all[t_idx, c_idx].astype(np.float32)
    cents = cent_sums / np.maximum(counts, 1.0)[:, None]
    NC_pad = NC_pad or pad_dim(max(NC, 8))
    minN, maxN, ncand, meta_nc_pad = _smetac_block_shapes(cfg, NC, NC_pad)
    return _PreparedBlock(
        t_idx=t_idx, c_idx=c_idx, cent_sums=cent_sums, counts=counts,
        cents=cents, NC=NC, NC_pad=NC_pad, minN=minN, maxN=maxN,
        ncand=ncand, meta_nc_pad=meta_nc_pad,
    )


def _finish_block(
    fold_results: List[dict],
    cfg: SharpConfig,
    prep: _PreparedBlock,
    tf: np.ndarray,
    n_final: int,
) -> FuseResult:
    """Map cells through the sMetaC table and aggregate meta centroids."""
    T = len(fold_results)
    nc_pad = cfg.nc_pad
    meta_nc_pad = prep.meta_nc_pad
    has_x0 = "x0" in fold_results[0]
    p = prep.cent_sums.shape[1]
    tf_real = tf[: prep.NC]

    # exact weighted meta centroids from the fold-cluster centroid sums
    meta_cent_sum = np.zeros((meta_nc_pad, p), np.float32)
    meta_counts = np.zeros(meta_nc_pad, np.float32)
    np.add.at(meta_cent_sum, tf_real, prep.cent_sums)
    np.add.at(meta_counts, tf_real, prep.counts)
    meta_cents = meta_cent_sum / np.maximum(meta_counts, 1.0)[:, None]

    # per-fold local cluster id -> meta label table (garbage slot at
    # meta_nc_pad - 1 for empty/padded slots)
    local_map = np.full((T, nc_pad), meta_nc_pad - 1, np.int32)
    local_map[prep.t_idx, prep.c_idx] = tf_real

    labels_parts = []
    x0_parts = []
    for t, fr in enumerate(fold_results):
        labels_parts.append(local_map[t][fr["finalC"]])
        if has_x0:
            # x0 columns remapped (summed) onto global meta clusters
            M = np.zeros((nc_pad, meta_nc_pad), np.float32)
            cc = np.nonzero(local_map[t] < meta_nc_pad - 1)[0]
            M[cc, local_map[t][cc]] = 1.0
            x0_parts.append(fr["x0"] @ M)

    return FuseResult(
        labels=np.concatenate(labels_parts),
        n_final=int(n_final),
        x0=np.concatenate(x0_parts, axis=0) if has_x0 else None,
        cents=meta_cents,
        counts=meta_counts,
    )


def _warn_overflow(fold_results: List[dict]) -> None:
    T = len(fold_results)
    n_over = sum(1 for fr in fold_results if fr.get("overflow"))
    if n_over:
        log(
            f"WARNING: wMetaC cluster budget (allc_pad) overflowed in "
            f"{n_over}/{T} folds — consensus is degraded; raise "
            f"maxN_cluster/ensize_K headroom or partition into smaller folds"
        )


def _single_fold_result(fr: dict) -> FuseResult:
    """T == 1: the fold-local consensus IS the block meta clustering."""
    cents1 = fr["cent_sum"] / np.maximum(fr["counts"], 1.0)[:, None]
    return FuseResult(
        labels=fr["finalC"],
        n_final=fr["n_meta"],
        x0=fr.get("x0"),
        cents=cents1.astype(np.float32),
        counts=fr["counts"].astype(np.float32),
    )


def fuse_folds(
    fold_results: List[dict],
    cfg: SharpConfig,
    n_total: Optional[int] = None,
    finalN_cluster: Optional[int] = None,
) -> FuseResult:
    """Global sMetaC over per-fold cluster summaries (R/SHARP.R:747-773)."""
    _warn_overflow(fold_results)
    if len(fold_results) == 1:
        return _single_fold_result(fold_results[0])

    prep = _prepare_block(fold_results, cfg)
    cents = np.zeros((prep.NC_pad, prep.cents.shape[1]), np.float32)
    cents[: prep.NC] = prep.cents
    valid = np.zeros(prep.NC_pad, bool)
    valid[: prep.NC] = True

    sres = smetac(
        jnp.asarray(cents), jnp.asarray(valid), jnp.asarray(prep.NC),
        jnp.asarray(prep.maxN),
        minN=prep.minN, ncand=prep.ncand, meta_nc_pad=prep.meta_nc_pad,
        sil_thre=cfg.sil_thre, height_Ntimes=cfg.height_Ntimes,
        finalN_cluster=(
            jnp.asarray(finalN_cluster) if finalN_cluster is not None else None
        ),
        hmethod=cfg.hmethod, linkage_backend=cfg.linkage_backend,
    )
    return _finish_block(
        fold_results, cfg, prep, np.asarray(sres.tf), int(sres.n_final)
    )


def fuse_blocks(
    blocks_fold_results: List[List[dict]],
    cfg: SharpConfig,
    finalN_cluster: Optional[int] = None,
    group: int = 8,
) -> List[FuseResult]:
    """Batched per-block sMetaC fuse: one vmapped smetac per shape group.

    Semantically equivalent to `[fuse_folds(frs, cfg) for frs in blocks]`
    but blocks sharing an NC_pad bucket are fused in ONE vmapped device
    call — the latency-bound linkage merge loop amortizes across the
    batch, and each distinct shape compiles exactly once per process
    (the dominant cost of the round-2 per-block fuse).
    """
    import jax

    results: List[Optional[FuseResult]] = [None] * len(blocks_fold_results)
    preps: List[Optional[_PreparedBlock]] = [None] * len(blocks_fold_results)
    by_shape = {}
    for bi, frs in enumerate(blocks_fold_results):
        _warn_overflow(frs)
        if len(frs) == 1:
            results[bi] = _single_fold_result(frs[0])
            continue
        prep = _prepare_block(frs, cfg)
        preps[bi] = prep
        shape_key = (prep.NC_pad, prep.minN, prep.ncand, prep.meta_nc_pad)
        by_shape.setdefault(shape_key, []).append(bi)

    for (NC_pad, minN, ncand, meta_nc_pad), idxs in by_shape.items():
        def one(c, v, n, m, fN):
            return smetac(
                c, v, n, m,
                minN=minN, ncand=ncand, meta_nc_pad=meta_nc_pad,
                sil_thre=cfg.sil_thre, height_Ntimes=cfg.height_Ntimes,
                finalN_cluster=fN if finalN_cluster is not None else None,
                hmethod=cfg.hmethod, linkage_backend=cfg.linkage_backend,
            )

        batched = jax.vmap(one) if finalN_cluster is not None else jax.vmap(
            lambda c, v, n, m: one(c, v, n, m, None)
        )
        for g0 in range(0, len(idxs), group):
            chunk = idxs[g0 : g0 + group]
            # pad short batches to the full group width (replicating the
            # first block; extras discarded) so ONE batch shape compiles
            # per bucket regardless of how many blocks remain — and a
            # 1-block warmup run compiles the same program a 26-block
            # run executes
            G = group
            padded = chunk + [chunk[0]] * (G - len(chunk))
            p = preps[chunk[0]].cents.shape[1]
            cents = np.zeros((G, NC_pad, p), np.float32)
            valid = np.zeros((G, NC_pad), bool)
            NCs = np.zeros(G, np.int32)
            maxNs = np.zeros(G, np.int32)
            for gi, bi in enumerate(padded):
                pr = preps[bi]
                cents[gi, : pr.NC] = pr.cents
                valid[gi, : pr.NC] = True
                NCs[gi] = pr.NC
                maxNs[gi] = pr.maxN
            args = (
                jnp.asarray(cents), jnp.asarray(valid),
                jnp.asarray(NCs), jnp.asarray(maxNs),
            )
            if finalN_cluster is not None:
                args = args + (
                    jnp.full((G,), finalN_cluster, jnp.int32),
                )
            sres = jax.block_until_ready(batched(*args))
            tfs = np.asarray(sres.tf)
            nfs = np.asarray(sres.n_final)
            for gi, bi in enumerate(chunk):
                results[bi] = _finish_block(
                    blocks_fold_results[bi], cfg, preps[bi],
                    tfs[gi], int(nfs[gi]),
                )
    return results


def sharp_large(
    X: np.ndarray,
    cfg: SharpConfig,
    key: jax.Array,
    timer: Optional[StageTimer] = None,
    R_all=None,
) -> SharpResult:
    """Large-data path ~ SHARP_large (R/SHARP.R:478-851). Single-process
    fold loop; the sharded/multi-host variant lives in sharp_tpu/parallel.

    `R_all` injects pre-generated stacked RP matrices (the reference's
    `rM` argument, R/SHARP.R:541-549); default: generated from `key`.
    """
    timer = timer or StageTimer()
    n, genes = X.shape

    with timer.stage("log_decision"):
        logf = resolve_log_transform(X, cfg, key)

    with timer.stage("permute_partition"):
        if n < 1e5:
            perm = np.asarray(
                jax.random.permutation(shuffle_key(key), n, independent=True)
            )
        else:
            perm = np.arange(n)
        sizes = fold_sizes(n, cfg.partition_ncells)
        T = len(sizes)
        block_pad = pad_dim(max(sizes))
        log(f"large path: {n} cells -> {T} folds, block_pad={block_pad}")

    with timer.stage("rp_setup"):
        if R_all is None:
            R_all = ensemble_rp_matrix(
                key, cfg.ensize_K, genes, cfg.reduced_ndim,
                dtype=jnp.dtype(cfg.dtype_compute),
            )

    with timer.stage("fold_ensemble"):
        from sharp_tpu.parallel.mesh import resolve_mesh

        mesh = resolve_mesh(cfg)
        if mesh is not None and T > 1:
            from sharp_tpu.parallel.sharded import process_folds_sharded

            X_folds = np.zeros((T, block_pad, genes), np.float32)
            off = 0
            for t, sz in enumerate(sizes):
                X_folds[t, :sz] = X[perm[off : off + sz]]
                off += sz
            fold_results = process_folds_sharded(
                X_folds, np.asarray(sizes), R_all, cfg, logf, mesh
            )
        elif T > 1:
            from sharp_tpu.parallel.sharded import process_folds_grouped

            fold_results = process_folds_grouped(
                X[perm], sizes, block_pad, R_all, cfg, logf,
            )
        else:
            fold_results = [
                process_fold(X[perm], sizes[0], block_pad, R_all, cfg, logf)
            ]

    with timer.stage("smetac"):
        fres = fuse_folds(
            fold_results, cfg, n_total=n, finalN_cluster=cfg.N_cluster
        )
        raw_labels, n_final, x0 = fres.labels, fres.n_final, fres.x0

    with timer.stage("finalize"):
        # un-permute
        unperm_labels = np.empty(n, np.int32)
        unperm_labels[perm] = raw_labels
        x0_u = None
        if x0 is not None:
            x0_u = np.empty_like(x0)
            x0_u[perm] = x0
        viE = None
        if cfg.forview:
            viE = np.empty((n, cfg.reduced_ndim), np.float32)
            off = 0
            for t, sz in enumerate(sizes):
                viE[perm[off : off + sz]] = fold_results[t]["mean_proj"]
                off += sz
        merge_tiny = cfg.N_cluster is None and n > 1e4
        labels = finalize_labels(unperm_labels, merge_tiny=merge_tiny)
        vals, counts = np.unique(labels, return_counts=True)
        folds_per_cell = np.empty(n, np.int32)
        off = 0
        for t, sz in enumerate(sizes):
            folds_per_cell[perm[off : off + sz]] = t
            off += sz

    return SharpResult(
        pred_clusters=labels,
        N_pred_cluster=len(vals),
        unique_pred_clusters=[int(v) for v in vals],
        distr_pred_clusters={int(v): int(c) for v, c in zip(vals, counts)},
        viE=viE,
        x0=x0_u if cfg.forview else None,
        paras=cfg.as_dict(),
        timing=timer.as_dict(),
        per_member_k=np.stack([fr["k_per"] for fr in fold_results]),
        per_member_maxsil=np.stack([fr["maxsil"] for fr in fold_results]),
        folds=folds_per_cell,
    )
