"""Optimal hierarchical clustering with automatic cluster-count selection.

Accelerator equivalent of the reference's core clustering kernel
`get_opt_hclust` (R/get_opt_hclust.R:33-244): Ward linkage over a Pearson
(or 1-S) distance, a batched sweep of candidate cuts k in [minN, maxN], and
the three-stage selection rule chain:

  1. max *median* silhouette, ties broken by taking the middle tied index
     (R/get_opt_hclust.R:162-168);
  2. if max silhouette <= sil.thre: argmax CH index (:194-195);
  3. if CH picks the smallest k: dendrogram height-gap rule — first of the
     top-10 heights whose successor is > height.Ntimes x itself; cut at the
     midpoint height (:196-210).

Everything is one jitted function per (static-shape) problem size;
`n_real`, `maxN` and the fixed `N_cluster` may be traced scalars.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sharp_tpu.ops.distance import (
    pearson_distance,
    similarity_to_distance,
    standardize_rows,
    _unit_rows,
)
from sharp_tpu.ops.linkage import (
    MONOTONE_METHODS,
    ward_linkage_deferred as ward_linkage,
    ward_linkage as linkage_reference,
    ward_linkage_deferred,
    cutree_multi,
    real_heights_tail,
)
from sharp_tpu.ops.linkage import LinkageResult


def _general_linkage(D, hmethod: str):
    """Any reference hmethod. ward.D2 runs the recurrence on squared
    distances and reports sqrt heights (R hclust semantics); non-monotone
    methods (median/centroid) use the full-argmin reference loop."""
    if hmethod == "ward.D2":
        from sharp_tpu.ops.distance import PAD_PAD_DIST

        # square only real entries; structural pad tiers must keep their
        # ordering without overflowing f32
        D2 = jnp.where(D >= PAD_PAD_DIST, D, D * D)
        link = ward_linkage_deferred(D2, method="ward.D")
        return LinkageResult(link.merges, jnp.sqrt(jnp.maximum(link.heights, 0.0)))
    if hmethod in MONOTONE_METHODS:
        return ward_linkage_deferred(D, method=hmethod)
    return linkage_reference(D, method=hmethod)
from sharp_tpu.ops.silhouette import sweep_scores, sweep_scores_nested

# numpy scalar, NOT jnp.float32(...): calling a jnp scalar type creates a
# device array at import time, initializing the XLA backend and locking
# out jax.distributed.initialize for multihost runs
import numpy as _np

_NEG = _np.float32(-_np.inf)


class OptHclust(NamedTuple):
    labels: jax.Array    # (n_pad,) int32 dense ids in [0, k); pads at nc_pad-1
    k: jax.Array         # () int32 chosen cluster count
    maxsil: jax.Array    # () f32 max median silhouette over the sweep
    msil: jax.Array      # (ncand,) f32 per-candidate median silhouette
    ch: jax.Array        # (ncand,) f32 per-candidate CH index
    oind: jax.Array      # () int32 chosen candidate index
    heights: jax.Array   # (n_pad - 1,) f32 merge heights
    all_labels: jax.Array  # (ncand, n_pad) labels of every candidate cut
    valid: jax.Array     # (ncand,) bool — candidate is testable (k <= n_real-1 etc.)


def _middle_tied_argmax(x: jax.Array, valid: jax.Array) -> jax.Array:
    """Index of the middle element among ties for the maximum
    (R: tmp[ceiling(length(tmp)/2)], R/get_opt_hclust.R:162-168)."""
    xm = jnp.where(valid, x, _NEG)
    mx = jnp.max(xm)
    tied = (xm == mx) & valid
    cnt = jnp.sum(tied.astype(jnp.int32))
    target = (cnt + 1) // 2
    csum = jnp.cumsum(tied.astype(jnp.int32))
    return jnp.argmax(csum >= target)


def _prep_distance(mat, real_mask, symmetric: bool):
    if symmetric:
        D = similarity_to_distance(mat, real_mask)
        feats = mat  # CH uses S itself as features (R/get_opt_hclust.R:111,144)
    else:
        Z = standardize_rows(mat, real_mask)
        D = pearson_distance(Z, real_mask)
        feats = Z
    mi = real_mask[:, None]
    mj = real_mask[None, :]
    D_real = jnp.where(mi & mj, D, 0.0)
    n = D.shape[-1]
    D_real = jnp.where(jnp.eye(n, dtype=bool), 0.0, D_real)
    feats_unit = _unit_rows(feats) * real_mask[:, None].astype(jnp.float32)
    return D, D_real, feats_unit


@functools.partial(
    jax.jit,
    static_argnames=(
        "symmetric", "minN", "ncand", "nc_pad", "height_tail", "hmethod",
        "linkage_backend",
    ),
)
def opt_hclust(
    mat: jax.Array,
    real_mask: jax.Array,
    n_real: jax.Array,
    maxN: jax.Array,
    *,
    symmetric: bool,
    minN: int,
    ncand: int,
    nc_pad: int,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    N_cluster: Optional[jax.Array] = None,
    height_tail: int = 10,
    hmethod: str = "ward.D",
    linkage_backend: str = "xla",
) -> OptHclust:
    """Cluster `mat` ((n_pad, p) features or (n_pad, n_pad) similarity).

    If `N_cluster` is given (traced scalar >= 2), performs the single fixed
    cut (R/get_opt_hclust.R:90-107) — the sweep still runs (static shapes)
    but selection is forced to that candidate.

    `linkage_backend` is one of "xla" | "rnn" | "rnn_bf16" (or "auto",
    resolved per platform by `resolve_linkage_backend`): "xla" is the
    serial loop, the rnn values the reciprocal-NN-rounds ladder with f32
    or bf16 matrix storage.
    Candidate cuts replay in the Pallas-Triton kernel on the GPU
    (ops/cutree_pallas.py; it shortens the fold program, PERF.md)
    and in the XLA loop elsewhere.
    """
    from sharp_tpu.ops import linkage

    linkage_backend = linkage.resolve_linkage_backend(linkage_backend, hmethod)
    D, D_real, feats_unit = _prep_distance(mat, real_mask, symmetric)
    if linkage_backend.startswith("rnn"):
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        store = (
            jnp.bfloat16 if linkage_backend == "rnn_bf16" else None
        )
        link = ward_linkage_rnn(D, store_dtype=store)
    elif hmethod in ("ward.D",):
        link = ward_linkage(D)
    else:
        link = _general_linkage(D, hmethod)

    if linkage._platform() == "gpu":
        from sharp_tpu.ops import cutree_pallas

        cuts = cutree_pallas.cutree_multi_pallas(
            link.merges, n_real, real_mask, maxN,
            minN=minN, ncand=ncand, nc_pad=nc_pad,
        )
    else:
        cuts = cutree_multi(
            link.merges, n_real, real_mask, maxN,
            minN=minN, ncand=ncand, nc_pad=nc_pad,
        )
    msil, ch = sweep_scores_nested(
        D_real, feats_unit, link.merges, cuts.labels, real_mask, n_real,
        maxN, minN=minN, ncand=ncand, nc_pad=nc_pad,
    )

    valid = cuts.valid
    # --- rule 1: middle-tied max median silhouette, with a height-gap
    # tie-break for NEAR ties. The median saturates on inputs with
    # near-duplicate points — sMetaC's centroid summaries carry T
    # fold-replicas per true cluster, so merging two real clusters moves
    # only ~T of NC points and the median shifts by ~1e-5: the argmax
    # becomes a coin flip decided by float noise (observed on-device:
    # msil(k=10..13) within 6e-5 while the dendrogram shows duplicate
    # merges at h<=0.0023 and real merges at h>=1.67). Candidates within
    # SIL_TIE_EPS of the max are re-ranked by the RATIO of the first
    # refused merge height to the last accepted one — the cut with the
    # cliff under it wins. This generalizes the reference's own
    # height-gap fallback (R/get_opt_hclust.R:196-210) and deviates from
    # its exact-tie middle rule (:162-168), which is kept when no near
    # tie exists. (CH is unusable as the tie-break: with within-cluster
    # dispersion ~0 it keeps growing past the true k.) ---
    maxsil = jnp.max(jnp.where(valid, msil, _NEG))
    SIL_TIE_EPS = 1e-4
    near = valid & (jnp.where(valid, msil, _NEG) >= maxsil - SIL_TIE_EPS)
    n_near = jnp.sum(near.astype(jnp.int32))
    ks_cand = minN + jnp.arange(ncand)
    midx_all = jnp.arange(link.heights.shape[0])
    t_next = jnp.clip(n_real - ks_cand, 0, link.heights.shape[0] - 1)
    t_last = jnp.clip(n_real - ks_cand - 1, 0, link.heights.shape[0] - 1)
    h_next = jnp.take(link.heights, t_next)
    h_last = jnp.where(
        ks_cand >= n_real, 0.0, jnp.take(link.heights, t_last)
    )
    # data-scaled epsilon floor: with a bare 1e-12, an exact-duplicate
    # merge (h_last == 0) would win the re-rank by a noise-scaled ~1e12
    # ratio rather than a principled margin (advisor r2)
    h_scale = jnp.max(
        jnp.where(midx_all < n_real - 1, link.heights, 0.0)
    )
    gap_eps = jnp.maximum(1e-6 * h_scale, 1e-12)
    gap_ratio = (h_next + gap_eps) / (jnp.maximum(h_last, 0.0) + gap_eps)
    gap_among_near = jnp.argmax(jnp.where(near, gap_ratio, _NEG))
    sil_oind = jnp.where(
        n_near > 1, gap_among_near, _middle_tied_argmax(msil, valid)
    ).astype(jnp.int32)

    # --- rule 2: CH fallback ---
    ch_oind = jnp.argmax(jnp.where(valid, ch, _NEG))

    # --- rule 3: height-gap fallback (only if CH picked the first candidate) ---
    tailh, tail_valid = real_heights_tail(link.heights, n_real, tail=height_tail)
    succ = tailh[1:]
    pred = tailh[:-1]
    pair_valid = tail_valid[1:]
    flag = ((succ - pred) > (height_Ntimes - 1.0) * pred) & pair_valid
    any_flag = jnp.any(flag)
    pind = jnp.argmax(flag)
    opth = 0.5 * (pred[pind] + succ[pind])
    # clusters after cutting at height opth: n_real - #{real merges with h <= opth}
    midx = jnp.arange(link.heights.shape[0])
    below = jnp.sum(
        ((link.heights <= opth) & (midx < n_real - 1)).astype(jnp.int32)
    )
    k_cut = n_real - below
    hg_oind = jnp.clip(k_cut - minN, 0, ncand - 1)

    use_ch = maxsil <= sil_thre
    hg_applies = use_ch & (ch_oind == 0) & any_flag
    oind = jnp.where(
        use_ch, jnp.where(hg_applies, hg_oind, ch_oind), sil_oind
    ).astype(jnp.int32)

    if N_cluster is not None:
        oind = jnp.clip(jnp.asarray(N_cluster, jnp.int32) - minN, 0, ncand - 1)

    labels = cuts.labels[oind]
    k = cuts.k[oind]
    return OptHclust(
        labels=labels,
        k=k,
        maxsil=maxsil,
        msil=msil,
        ch=ch,
        oind=oind,
        heights=link.heights,
        all_labels=cuts.labels,
        valid=valid,
    )


# --- host-facing wrappers (numpy in/out, reference return schema) --------

def _pad_problem(mat, symmetric: bool):
    import numpy as np

    from sharp_tpu.config import pad_dim

    n = mat.shape[0]
    npad = pad_dim(n)
    mask = np.zeros(npad, bool)
    mask[:n] = True
    if symmetric:
        Mp = np.zeros((npad, npad), np.float32)
        Mp[:n, :n] = mat
    else:
        Mp = np.zeros((npad, mat.shape[1]), np.float32)
        Mp[:n] = mat
    return Mp, mask, n


def get_opt_hclust(
    mat,
    hmethod: str = "ward.D",
    minN: int = 2,
    maxN: int = 40,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    N_cluster=None,
    flashmark: bool = False,
):
    """Public clustering kernel ~ reference `get_opt_hclust`
    (R/get_opt_hclust.R:33-244).

    `mat` is either a feature matrix (cells x p; Pearson-correlation
    distance, R :70-74) or a symmetric similarity matrix (d = 1 - S,
    R :66-69) — detected like the reference's isSymmetric. Returns a dict
    with the reference's fields: f (1-based labels), v (all candidate
    cuts), maxsil, msil, CHind, height, optN_cluster. `flashmark` is
    accepted for signature parity and ignored (see PARITY.md deviations).
    """
    import numpy as np

    mat = np.asarray(mat, np.float32)
    symmetric = (
        mat.ndim == 2
        and mat.shape[0] == mat.shape[1]
        and np.allclose(mat, mat.T, atol=1e-6)
    )
    Mp, mask, n = _pad_problem(mat, symmetric)
    maxN = int(min(maxN, n - 1))
    ncand = max(maxN - minN + 1, 1)
    nc_pad = ((min(maxN, 40) + 9) // 8) * 8
    res = opt_hclust(
        jnp.asarray(Mp), jnp.asarray(mask), jnp.asarray(n),
        jnp.asarray(maxN),
        symmetric=symmetric, minN=minN, ncand=ncand, nc_pad=nc_pad,
        sil_thre=sil_thre, height_Ntimes=height_Ntimes,
        N_cluster=(jnp.asarray(N_cluster) if N_cluster is not None else None),
        hmethod=hmethod,
    )
    return {
        "f": np.asarray(res.labels)[:n] + 1,
        "v": np.asarray(res.all_labels)[:, :n] + 1,
        "maxsil": float(res.maxsil),
        "msil": np.asarray(res.msil),
        "CHind": np.asarray(res.ch),
        "height": np.asarray(res.heights)[: n - 1],
        "optN_cluster": int(res.k),
        "oind": int(res.oind),
    }


def gethclust(d, my):
    """Legacy exported kernel ~ reference `gethclust`
    (R/getrowColor.R:134-218): fixed ward.D over a precomputed distance,
    candidate cuts k = 2..min(40, n-1), middle-tied max median silhouette
    with CH fallback at sil <= 0.35 — no height-gap rule.

    d: (n, n) distance matrix. my: (n, p) feature matrix for the CH
    index ("1-corr" variant). Returns the reference's result fields.
    """
    import numpy as np

    from sharp_tpu.config import pad_dim
    from sharp_tpu.ops.distance import (
        PAD_PAD_DIST,
        PAD_REAL_DIST,
        _unit_rows,
    )

    d = np.asarray(d, np.float32)
    my = np.asarray(my, np.float32)
    n = d.shape[0]
    npad = pad_dim(n)
    mask = np.arange(npad) < n
    Dp = np.full((npad, npad), PAD_PAD_DIST, np.float32)
    Dp[:n, :n] = d
    Dp[:n, n:] = PAD_REAL_DIST
    Dp[n:, :n] = PAD_REAL_DIST
    np.fill_diagonal(Dp, 0.0)
    Myp = np.zeros((npad, my.shape[1]), np.float32)
    Myp[:n] = my

    maxN = min(40, n - 1)
    minN = 2
    ncand = max(maxN - minN + 1, 1)
    nc_pad = ((maxN + 9) // 8) * 8
    maskj = jnp.asarray(mask)
    nj = jnp.asarray(n)
    link = ward_linkage(jnp.asarray(Dp))
    cuts = cutree_multi(
        link.merges, nj, maskj, jnp.asarray(maxN),
        minN=minN, ncand=ncand, nc_pad=nc_pad,
    )
    D_real = jnp.asarray(np.where(np.eye(npad, dtype=bool), 0.0,
                                  np.where(np.outer(mask, mask), Dp, 0.0)))
    feats_unit = _unit_rows(jnp.asarray(Myp)) * maskj[:, None].astype(
        jnp.float32
    )
    msil, ch = sweep_scores_nested(
        D_real, feats_unit, link.merges, cuts.labels, maskj, nj,
        jnp.asarray(maxN), minN=minN, ncand=ncand, nc_pad=nc_pad,
    )
    valid = cuts.valid
    sil_oind = _middle_tied_argmax(msil, valid)
    maxsil = jnp.max(jnp.where(valid, msil, _NEG))
    ch_oind = jnp.argmax(jnp.where(valid, ch, _NEG))
    oind = jnp.where(maxsil <= 0.35, ch_oind, sil_oind)
    return {
        "f": np.asarray(cuts.labels[oind])[:n] + 1,
        "maxsil": float(maxsil),
        "msil": np.asarray(msil),
        "CHind": np.asarray(ch),
        "height": np.asarray(link.heights)[: n - 1],
        "oind": int(oind),
    }
