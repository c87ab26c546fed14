"""Single-block ensemble clustering: project K ways, cluster each, in batch.

The reference's per-(RP k, fold t) worker (R/SHARP.R:554-618: slice fold,
log2, dense RP matmul, getrowColor -> get_opt_hclust) becomes one jitted
function: a single matmul projects all K members at once and the Ward/
selection kernel is vmapped over the ensemble axis — the reference's
`foreach(k) %dopar%` fan-out becomes a batch dimension.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sharp_tpu.ops.rp import rp_project_ensemble
from sharp_tpu.ops.select import opt_hclust


class BlockEnsembleResult(NamedTuple):
    labels: jax.Array    # (n_pad, K) dense per-member labels; pads at nc_pad-1
    k_per: jax.Array     # (K,) chosen cluster count per member
    maxsil: jax.Array    # (K,) max median silhouette per member
    mean_proj: jax.Array  # (n_pad, p) ensemble-mean projected features (viE block)


@functools.partial(
    jax.jit,
    static_argnames=("K", "minN", "ncand", "nc_pad", "linkage_backend", "hmethod"),
)
def cluster_block_ensemble(
    X: jax.Array,           # (n_pad, genes) raw (not log) expression block
    real_mask: jax.Array,   # (n_pad,)
    n_real: jax.Array,      # () traced
    R_all: jax.Array,       # (genes, K*p) stacked ensemble RP matrix
    maxN: jax.Array,        # () traced
    log_transform: jax.Array,  # () traced bool
    *,
    K: int,
    minN: int = 2,
    ncand: int = 39,
    nc_pad: int = 48,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    indN_cluster: Optional[jax.Array] = None,
    linkage_backend: str = "xla",
    hmethod: str = "ward.D",
) -> BlockEnsembleResult:
    Xt = jnp.where(log_transform, jnp.log2(1.0 + X), X)
    proj = rp_project_ensemble(Xt, R_all, K=K)          # (K, n_pad, p)
    proj = proj * real_mask[None, :, None].astype(proj.dtype)

    def one(Z):
        res = opt_hclust(
            Z, real_mask, n_real, maxN,
            symmetric=False, minN=minN, ncand=ncand, nc_pad=nc_pad,
            sil_thre=sil_thre, height_Ntimes=height_Ntimes,
            N_cluster=indN_cluster,
            hmethod=hmethod,
            linkage_backend=linkage_backend,
        )
        return res.labels, res.k, res.maxsil

    labels, k_per, maxsil = jax.vmap(one)(proj)
    return BlockEnsembleResult(
        labels=labels.T,
        k_per=k_per,
        maxsil=maxsil,
        mean_proj=jnp.mean(proj, axis=0),
    )
