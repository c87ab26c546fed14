"""Weighted meta-clustering (wMetaC) — ensemble label fusion on the device.

Fuses the (n, K) matrix of per-RP cluster labels into one consensus
labelling, following the reference algorithm (R/wMetaC.R:15-226):

  1. co-association A = mean_k [label_i == label_j]            (:24-25)
  2. entry weights a(1-a)                                      (:30-36)
  3. cell weights w0 = 4/N * rowSums, w1 = (w0+0.01)/1.01      (:41-44)
  4. member-distinct cluster ids (label, k)                    (:60-64)
  5. cluster-pair similarity = w1-weighted Jaccard of members  (:70-77)
  6. hierarchical meta-clustering of S via opt_hclust
     (sil.thre defaults to 0 here)                             (:94-99)
  7. per-cell majority vote over mapped member labels          (:141-143)
  8. single-cluster fallback: prefer the runner-up vote        (:147-161)
  9. visualization matrix x0: 1 at own cluster,
     0.5 * count-ratio elsewhere                               (:179-208)

Re-design: labels are dense integers (member k, slot c) instead
of strings like "red_p3"; every set operation becomes a masked one-hot
matmul; the C(allC, 2) pairwise Jaccard loop is one (allC, n) x (n, allC)
matmul over weighted membership rows. All shapes static: the global
cluster axis is compacted to `allc_pad` slots via a fixed-size nonzero.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sharp_tpu.ops.select import opt_hclust


class WMetaCResult(NamedTuple):
    finalC: jax.Array     # (n_pad,) int32 consensus labels in [0, n_meta); pads -> nc_pad-1
    n_meta: jax.Array     # () int32 number of consensus clusters
    x0: jax.Array         # (n_pad, nc_pad) f32 visualization matrix
    tf: jax.Array         # (allc_pad,) meta label of each compacted member-cluster
    allC: jax.Array       # () int32 number of distinct member clusters
    overflow: jax.Array   # () bool — allc_pad budget exceeded (results degraded)


@functools.partial(
    jax.jit,
    static_argnames=(
        "K", "nc_pad", "allc_pad", "meta_ncand", "meta_minN", "hmethod",
        "linkage_backend",
    ),
)
def wmetac(
    labels: jax.Array,       # (n_pad, K) dense per-member labels; pads at nc_pad-1
    real_mask: jax.Array,    # (n_pad,) bool
    n_real: jax.Array,       # () traced
    maxN: jax.Array,         # () traced max clusters for the meta hclust
    *,
    K: int,
    nc_pad: int,
    allc_pad: int = 256,
    meta_minN: int = 2,
    meta_ncand: int = 39,
    sil_thre: float = 0.0,
    height_Ntimes: float = 2.0,
    enN_cluster: Optional[jax.Array] = None,
    hmethod: str = "ward.D",
    linkage_backend: str = "xla",
) -> WMetaCResult:
    n_pad = labels.shape[0]
    rm = real_mask.astype(jnp.float32)

    # --- member one-hots, garbage slot excluded --------------------------
    oh = jax.nn.one_hot(labels, nc_pad, dtype=jnp.float32)      # (n, K, nc)
    oh = oh * rm[:, None, None]
    oh = oh.at[:, :, nc_pad - 1].set(0.0)

    # --- 1-3: co-association and cell weights ----------------------------
    ohf = jnp.transpose(oh, (1, 0, 2))                          # (K, n, nc)
    AA = jnp.einsum(
        "kic,kjc->ij", ohf, ohf, preferred_element_type=jnp.float32
    ) / K                                                        # (n, n)
    newAA = AA * (1.0 - AA)
    w0 = (4.0 / jnp.maximum(n_real, 1)) * jnp.sum(newAA, axis=1)
    w1 = (w0 + 0.01) / 1.01
    w1 = w1 * rm                                                 # pads weightless

    # --- 4: compact global cluster ids ----------------------------------
    # global slot g = k * nc_pad + c ; occupancy from real cells only
    occ_grid = jnp.sum(ohf, axis=1) > 0.5                        # (K, nc)
    occ_flat = occ_grid.reshape(-1)                              # (K*nc,)
    total_occ = jnp.sum(occ_flat.astype(jnp.int32))
    comp_ids = jnp.nonzero(
        occ_flat, size=allc_pad, fill_value=K * nc_pad - 1
    )[0]                                                         # (allc_pad,)
    slot_idx = jnp.arange(allc_pad)
    comp_valid = slot_idx < total_occ
    overflow = total_occ > allc_pad

    # membership matrix M: (allc_pad, n) over real cells
    M_full = jnp.transpose(oh, (1, 2, 0)).reshape(K * nc_pad, n_pad)
    M = M_full[comp_ids] * comp_valid[:, None].astype(jnp.float32)

    # --- 5: w1-weighted Jaccard similarity ------------------------------
    Mw = M * w1[None, :]
    # exact: w1-weighted membership values pass through a one-hot matmul;
    # a reduced-precision matmul would round w1
    inter = jnp.dot(
        Mw, M.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    wsum = jnp.sum(Mw, axis=1)
    union = wsum[:, None] + wsum[None, :] - inter
    S = jnp.where((inter > 0) & (union > 1e-12), inter / jnp.maximum(union, 1e-12), 0.0)
    S = jnp.where(jnp.eye(allc_pad, dtype=bool), 1.0, S)

    # --- 6: meta hierarchical clustering --------------------------------
    allC = jnp.minimum(total_occ, allc_pad)
    meta = opt_hclust(
        S,
        comp_valid,
        allC,
        jnp.minimum(maxN, allC - 1),
        symmetric=True,
        minN=meta_minN,
        ncand=meta_ncand,
        nc_pad=nc_pad,
        sil_thre=sil_thre,
        height_Ntimes=height_Ntimes,
        N_cluster=enN_cluster,
        hmethod=hmethod,
        linkage_backend=linkage_backend,
    )
    tf = meta.labels                                             # (allc_pad,)

    # --- 7: majority vote ------------------------------------------------
    # inverse map: global slot -> compacted position (garbage -> allc_pad-1 slot
    # whose tf we overwrite to the meta garbage id)
    inv = jnp.full((K * nc_pad,), allc_pad, jnp.int32)
    inv = inv.at[comp_ids].set(slot_idx.astype(jnp.int32))
    tf_ext = jnp.concatenate([tf, jnp.array([nc_pad - 1], jnp.int32)])
    g = (jnp.arange(K)[None, :] * nc_pad + labels).astype(jnp.int32)  # (n, K)
    member_meta = tf_ext[inv[g]]                                 # (n, K)

    votes_oh = jax.nn.one_hot(member_meta, nc_pad, dtype=jnp.float32)
    votes_oh = votes_oh.at[:, :, nc_pad - 1].set(0.0)
    votes = jnp.sum(votes_oh, axis=1)                            # (n, nc_pad)
    finalC = jnp.argmax(votes, axis=1).astype(jnp.int32)

    # --- 8: single-cluster fallback (R/wMetaC.R:147-161) -----------------
    def count_unique(lbl):
        occ = jnp.sum(
            jax.nn.one_hot(lbl, nc_pad, dtype=jnp.float32)
            * rm[:, None],
            axis=0,
        ) > 0.5
        occ = occ.at[nc_pad - 1].set(False)
        return jnp.sum(occ.astype(jnp.int32))

    n_unique = count_unique(finalC)
    votes2 = jnp.where(
        jax.nn.one_hot(finalC, nc_pad, dtype=jnp.float32) > 0.5,
        -1.0, votes,
    )
    second = jnp.argmax(votes2, axis=1).astype(jnp.int32)
    has_second = jnp.max(votes2, axis=1) > 0.5
    alt = jnp.where(has_second, second, finalC)
    finalC = jnp.where(n_unique == 1, alt, finalC)
    n_unique = count_unique(finalC)

    finalC = jnp.where(real_mask, finalC, nc_pad - 1).astype(jnp.int32)

    # --- 9: visualization matrix x0 (one-hot forms: row gathers/scatters
    # are kept out of the program) ---------------------------------------
    oh_final = jax.nn.one_hot(finalC, nc_pad, dtype=jnp.float32)
    own = jnp.sum(oh_final * votes, axis=1, keepdims=True)
    x0 = jnp.where(votes > 0, 0.5 * votes / jnp.maximum(own, 1e-12), 0.0)
    x0 = jnp.where(oh_final > 0.5, 1.0, x0)
    x0 = x0 * rm[:, None]
    x0 = x0.at[:, nc_pad - 1].set(0.0)

    return WMetaCResult(
        finalC=finalC,
        n_meta=n_unique,
        x0=x0,
        tf=tf,
        allC=allC,
        overflow=overflow,
    )
