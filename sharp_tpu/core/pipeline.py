"""SHARP pipeline drivers: preprocessing, testlog, and the small path.

The small path (n < base.ncells) mirrors SHARP_small (R/SHARP.R:339-454):
log2 -> K-member RP ensemble -> per-member Ward + model selection ->
wMetaC fusion -> tiny-cluster merge -> first-occurrence relabel. One
padded block, everything jitted; the K-way `foreach` fan-out is a vmap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sharp_tpu.config import SharpConfig, pad_dim
from sharp_tpu.core.block import cluster_block_ensemble
from sharp_tpu.core.wmetac import wmetac
from sharp_tpu.ops.rp import ensemble_rp_matrix, ternary_rp_matrix, rp_project
from sharp_tpu.ops.select import opt_hclust
from sharp_tpu.types import SharpResult, finalize_labels
from sharp_tpu.utils.prng import member_key, testlog_key
from sharp_tpu.utils.timers import StageTimer, log


def preprocess(
    X: np.ndarray,
    cfg: SharpConfig,
    gene_names: Optional[np.ndarray] = None,
    cell_names: Optional[np.ndarray] = None,
):
    """Dedup genes/cells, clamp negatives, drop all-zero genes, normalize.

    Mirrors R/SHARP.R:82-117: duplicate gene/cell-name removal, `prep`
    (negative clamp + all-zero-gene drop), and CPM normalization when
    exp.type is given and is neither CPM nor TPM. X is cells x genes.
    """
    keep_cells = slice(None)
    if cell_names is not None:
        _, idx = np.unique(np.asarray(cell_names), return_index=True)
        if len(idx) < X.shape[0]:
            keep_cells = np.sort(idx)
            X = X[keep_cells]
    if gene_names is not None:
        _, idx = np.unique(np.asarray(gene_names), return_index=True)
        if len(idx) < X.shape[1]:
            X = X[:, np.sort(idx)]
    if cfg.prep:
        X = np.maximum(X, 0)
        nz = X.sum(axis=0) > 0
        if not nz.all():
            X = X[:, nz]
    if cfg.exp_type is not None and cfg.exp_type.upper() not in ("CPM", "TPM"):
        per_cell = X.sum(axis=1, keepdims=True)
        X = X / np.maximum(per_cell, 1e-12) * 1e6
    return np.ascontiguousarray(X, dtype=np.float32)


def testlog_decide(
    X: np.ndarray, cfg: SharpConfig, key: jax.Array, sncells: Optional[int] = None
) -> bool:
    """Decide whether to log2-transform by probing a small random subset.

    Reference rule (R/SHARP.R:877-924): cluster `sncells` random cells with
    one fixed-seed RP both raw and log2-transformed; log is necessary iff
    msil_raw < 0.75 and msil_raw >= 0.95 * msil_log.
    """
    n = X.shape[0]
    sn = min(sncells if sncells is not None else cfg.sncells, n)
    perm = np.asarray(
        jax.random.permutation(testlog_key(key), n, independent=True)
    )
    sub = X[perm[:sn]]
    npad = pad_dim(sn)
    Xp = np.zeros((npad, X.shape[1]), np.float32)
    Xp[:sn] = sub
    mask = np.zeros(npad, bool)
    mask[:sn] = True
    # fixed-seed probe RP (the reference pins seed 5, R/SHARP.R:889)
    R = ternary_rp_matrix(jax.random.PRNGKey(5), X.shape[1], cfg.reduced_ndim)

    def maxsil_of(Z):
        res = opt_hclust(
            Z, jnp.asarray(mask), jnp.asarray(sn), jnp.asarray(40),
            symmetric=False, minN=2, ncand=39, nc_pad=cfg.nc_pad,
            sil_thre=0.0, height_Ntimes=2.0,
        )
        return float(res.maxsil)

    raw = maxsil_of(rp_project(jnp.asarray(Xp), R))
    logged = maxsil_of(rp_project(jnp.asarray(Xp), R, log_transform=True))
    flag = (raw < 0.75) and (raw >= 0.95 * logged)
    log(f"testlog: msil_raw={raw:.4f} msil_log={logged:.4f} -> log={flag}")
    return flag


def resolve_log_transform(
    X: np.ndarray, cfg: SharpConfig, key: jax.Array
) -> bool:
    """Reference decision tree for the final log2 flag (R/SHARP.R:202-228)."""
    if cfg.log_transform is not None:
        return bool(cfg.log_transform)
    if cfg.logflag is False:
        return True  # "Log-transform is employed!" without checking
    if cfg.logflag is None and cfg.n_cells >= 1e4:
        return True
    return testlog_decide(X, cfg, key)


def sharp_small(
    X: np.ndarray,
    cfg: SharpConfig,
    key: jax.Array,
    timer: Optional[StageTimer] = None,
    R_all: Optional[jax.Array] = None,
) -> SharpResult:
    """Small-data path ~ SHARP_small (R/SHARP.R:339-454).

    `R_all` injects pre-generated stacked RP matrices (the reference's
    `rM` argument, R/SHARP.R:541-549); default: generated from `key`.
    """
    timer = timer or StageTimer()
    n, genes = X.shape
    K = cfg.ensize_K
    p = cfg.reduced_ndim
    npad = pad_dim(n)

    with timer.stage("log_decision"):
        logf = resolve_log_transform(X, cfg, key)

    with timer.stage("stage_rp_setup"):
        Xp = np.zeros((npad, genes), np.float32)
        Xp[:n] = X
        mask = np.zeros(npad, bool)
        mask[:n] = True
        Xd = jnp.asarray(Xp)
        maskd = jnp.asarray(mask)
        if R_all is None:
            R_all = ensemble_rp_matrix(
                key, K, genes, p, dtype=jnp.dtype(cfg.dtype_compute)
            )

    with timer.stage("ensemble_cluster"):
        block = cluster_block_ensemble(
            Xd, maskd, jnp.asarray(n), R_all, jnp.asarray(cfg.maxN_cluster),
            jnp.asarray(logf),
            K=K, minN=cfg.minN_cluster,
            ncand=cfg.maxN_cluster - cfg.minN_cluster + 1,
            nc_pad=cfg.nc_pad, sil_thre=cfg.sil_thre,
            height_Ntimes=cfg.height_Ntimes,
            indN_cluster=(
                jnp.asarray(cfg.indN_cluster)
                if cfg.indN_cluster is not None
                else None
            ),
            linkage_backend=cfg.linkage_backend,
            hmethod=cfg.hmethod,
        )
        block = jax.block_until_ready(block)

    with timer.stage("wmetac"):
        wres = wmetac(
            block.labels, maskd, jnp.asarray(n),
            jnp.asarray(cfg.maxN_cluster),
            K=K, nc_pad=cfg.nc_pad, allc_pad=_allc_pad(cfg, K),
            meta_minN=cfg.minN_cluster,
            meta_ncand=cfg.maxN_cluster - cfg.minN_cluster + 1,
            sil_thre=0.0,  # wMetaC defaults sil.thre to 0 (R/wMetaC.R:94-97)
            height_Ntimes=cfg.height_Ntimes,
            enN_cluster=(
                jnp.asarray(cfg.N_cluster) if cfg.N_cluster is not None else None
            ),
        )
        wres = jax.block_until_ready(wres)

    with timer.stage("finalize"):
        raw = np.asarray(wres.finalC)[:n]
        merge_tiny = cfg.N_cluster is None and n > 1e4
        labels = finalize_labels(raw, merge_tiny=merge_tiny)
        vals, counts = np.unique(labels, return_counts=True)
        viE = np.asarray(block.mean_proj)[:n] if cfg.forview else None
        x0 = np.asarray(wres.x0)[:n] if cfg.forview else None

    return SharpResult(
        pred_clusters=labels,
        N_pred_cluster=len(vals),
        unique_pred_clusters=[int(v) for v in vals],
        distr_pred_clusters={int(v): int(c) for v, c in zip(vals, counts)},
        viE=viE,
        x0=x0,
        paras=cfg.as_dict(),
        timing=timer.as_dict(),
        per_member_k=np.asarray(block.k_per),
        per_member_maxsil=np.asarray(block.maxsil),
    )


def _allc_pad(cfg: SharpConfig, K: int) -> int:
    """Static budget for distinct (member, cluster) ids in wMetaC."""
    from sharp_tpu.core.fold import _allc_pad as _fp

    return _fp(cfg)
