"""Mesh-sharded fold processing: the multi-device large path.

The reference's K x T `foreach` fork fan-out (R/SHARP.R:554-618) maps to:
  * folds stacked on a leading T axis, sharded over the mesh "data" axis —
    each device runs its folds' full ensemble+wMetaC with zero cross-device
    traffic (the fold program is embarrassingly parallel);
  * the K-member ensemble axis optionally sharded over "ens";
  * the only collective is the implicit all-gather of O(clusters x p) fold
    summaries when the host fuses them with sMetaC — exactly the
    communication shape of the reference's sequential gather loops
    (R/SHARP.R:627-635, SURVEY.md §5.8).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sharp_tpu.config import SharpConfig
from sharp_tpu.core.fold import FoldSummary, fold_program, fold_static_args
from sharp_tpu.core.large import summaries_to_host, summary_to_host
from sharp_tpu.utils.timers import log


def _batched_fold_fn(static: dict):
    def one(X, mask, n_real, R_all, logf):
        return fold_program(
            X, mask, n_real, R_all, logf, None, has_indN=False, **static
        )

    return jax.vmap(one, in_axes=(0, 0, 0, None, None))


def hbm_budget_bytes() -> int:
    """Device-memory budget for staged fold groups.

    `SHARP_TPU_HBM_BUDGET` (bytes) overrides; otherwise 80% of the
    device's currently FREE memory as the runtime reports it. Sizing from
    free — not total — memory keeps the streaming path from running out
    of memory when the caller already holds device buffers. The CPU
    reports no memory stats and gets a fixed 8 GiB; any other device that
    reports none is an error, not a guess.
    """
    env = os.environ.get("SHARP_TPU_HBM_BUDGET")
    if env:
        return int(env)
    # min over local devices: on a heterogeneous multi-device host the
    # fullest device bounds what a replicated/sharded group can stage
    best = None
    for dev in jax.local_devices():
        if dev.platform == "cpu":
            continue
        stats = dev.memory_stats() or {}
        limit = int(stats.get("bytes_limit", 0))
        if limit <= 0:
            raise RuntimeError(
                f"{dev.device_kind} reports no memory limit "
                "(memory_stats()['bytes_limit']); set SHARP_TPU_HBM_BUDGET"
            )
        free = limit - int(stats.get("bytes_in_use", 0))
        best = free if best is None else min(best, free)
    if best is None:
        return 8 << 30
    return max(int(0.8 * best), 1 << 28)


def auto_group(
    block_pad: int, genes: int, sparse: bool, cap: int = 16
) -> int:
    """Memory-aware fold-group size.

    `cap=16` batches 16 folds x K members into one vmapped fold program:
    the linkage rounds are latency-bound, so a wider batch amortizes them.
    A group stages group x block_pad x genes f32 dense on device — ~230 MB
    a fold at the flagship shape — so the group is shrunk to fit the
    device-memory budget. The working-set multiplier: dense feed holds the
    staged next group, the current dense group, and the fold program's
    log2 copy (~3x); sparse feed stages only O(nnz) triplets and fuses
    log2 into the densify scatter (~1.5x + slack -> 2x).
    """
    fold_bytes = block_pad * genes * 4
    mult = 2.0 if sparse else 3.0
    fit = int(hbm_budget_bytes() / (mult * fold_bytes))
    # quantize to a short ladder: free-memory jitter must not mint new
    # group sizes — every distinct group is a distinct compiled shape
    for g in (16, 8, 4, 2):
        if fit >= g and cap >= g:
            return g
    return 1


def process_folds_grouped(
    X,                       # (n, genes) permuted cells, or a SparseBlock
    sizes,                   # fold sizes
    block_pad: int,
    R_all: jax.Array,
    cfg: SharpConfig,
    logf: bool,
    group: Optional[int] = None,
    wire_dtype: str = "float32",
) -> List[dict]:
    """Single-device fold pass, `group` folds per jit call.

    The linkage rounds are latency-bound, so batching folds into the
    vmapped fold program amortizes the per-round overhead across
    group x K ensemble members. `group=None` sizes the batch from the device-memory budget
    (`auto_group`).

    With a SparseBlock input, each group ships CSR triplets and scatters
    them into the dense padded folds ON DEVICE (io/sparse.densify_folds,
    with log2(1 + x) fused into the scatter) — at single-cell densities
    this cuts host->device traffic ~6x vs the dense form, and the next
    group's triplets are staged (host slice + async transfer) while the
    device runs the current fold program.
    """
    from sharp_tpu.io.sparse import (
        SparseBlock,
        densify_folds,
        fold_triplets,
        nnz_pad,
    )

    T = len(sizes)
    genes = X.shape[1]
    static = fold_static_args(cfg)
    sparse = isinstance(X, SparseBlock)
    fn = jax.jit(_batched_fold_fn(static))
    results = []
    if group is None:
        group = auto_group(block_pad, genes, sparse)
        log(f"fold group auto-sized to {group}")
    group = max(1, min(group, T))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    if sparse:
        fold_nnz = [
            int(X.indptr[offsets[t] + sizes[t]] - X.indptr[offsets[t]])
            for t in range(T)
        ]
        budget = nnz_pad(max(fold_nnz))

    import time as _time

    timing = (
        {"slice_s": 0.0, "transfer_s": 0.0, "device_s": 0.0,
         "readback_s": 0.0}
        if os.environ.get("SHARP_TPU_FOLD_TIMING") == "1"
        else None
    )

    def stage(g0):
        """Host-side slice + (async) device transfer for one group."""
        t0 = _time.perf_counter()
        gsizes = list(sizes[g0 : g0 + group])
        G = len(gsizes)
        pad_sizes = gsizes + [gsizes[0]] * (group - G)  # never recompile
        starts = [int(offsets[g0 + gi]) for gi in range(G)]
        starts += [starts[0]] * (group - G)
        if sparse:
            counts, cols, vals = fold_triplets(
                X, starts, pad_sizes, block_pad, budget,
                wire_dtype=wire_dtype,
            )
            t1 = _time.perf_counter()
            staged = (
                jax.device_put(counts), jax.device_put(cols),
                jax.device_put(vals),
            )
        else:
            Xg = np.zeros((group, block_pad, genes), np.float32)
            for gi, (r0, sz) in enumerate(zip(starts, pad_sizes)):
                Xg[gi, :sz] = X[r0 : r0 + sz]
            t1 = _time.perf_counter()
            staged = jax.device_put(Xg)
        if timing is not None:
            # force transfer completion ONLY when attributing time —
            # normally the async transfer overlaps the previous group
            jax.block_until_ready(staged)
            t2 = _time.perf_counter()
            timing["slice_s"] += t1 - t0
            timing["transfer_s"] += t2 - t1
        masks = np.arange(block_pad)[None, :] < np.asarray(pad_sizes)[:, None]
        return staged, masks, pad_sizes, gsizes

    # summaries are pulled in FLUSH-group batches: each pull is a
    # device-to-host round trip per summary field, so batching divides
    # their count by FLUSH at ~40 MB of held device summaries per
    # pending group
    FLUSH = 8
    pending_outs = []  # (FoldSummary (device, padded lanes), real sizes)

    def flush_outs():
        if not pending_outs:
            return
        if len(pending_outs) == 1:
            merged, lane_sizes = pending_outs[0][0], list(pending_outs[0][1])
            lane_sizes += [0] * (group - len(lane_sizes))
        else:
            merged = jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0),
                *(o for o, _ in pending_outs),
            )
            lane_sizes = []
            for _, gs in pending_outs:
                lane_sizes += list(gs) + [0] * (group - len(gs))
        frs = summaries_to_host(merged, lane_sizes, cfg.forview)
        results.extend(fr for fr, s in zip(frs, lane_sizes) if s > 0)
        pending_outs.clear()

    staged = stage(0)
    prev_out = None
    for g0 in range(0, T, group):
        data, masks, pad_sizes, gsizes = staged
        t0 = _time.perf_counter()
        if sparse:
            # log2(1 + x) fused into the O(nnz) scatter values — the
            # fold program then skips its dense log2 pass (one fewer
            # (G, block_pad, genes) HBM copy; bit-identical entries)
            Xg = densify_folds(
                *data, block_pad=block_pad, genes=genes, log2p1=logf
            )
            eff_logf = False
        else:
            Xg = data
            eff_logf = logf
        out = fn(
            Xg,
            jnp.asarray(masks),
            jnp.asarray(np.asarray(pad_sizes, np.int32)),
            R_all,
            jnp.asarray(eff_logf),
        )
        # stage the NEXT group while the device runs this one
        if g0 + group < T:
            staged = stage(g0 + group)
        if timing is not None:
            # attribution mode: synchronous per-group device timing.
            # ONE leaf: the XLA program completes atomically
            jax.block_until_ready(out.n_meta)
            timing["device_s"] += _time.perf_counter() - t0
        else:
            # depth-2 pipeline: wait for the PREVIOUS group while this
            # one executes — bounds the dispatch queue (2 groups of
            # staged triplets + one dense working set resident). Same
            # single-leaf discipline as above.
            if prev_out is not None:
                jax.block_until_ready(prev_out.n_meta)
            prev_out = out
        t0 = _time.perf_counter()
        pending_outs.append((out, gsizes))
        if len(pending_outs) >= FLUSH:
            flush_outs()
        if timing is not None:
            timing["readback_s"] += _time.perf_counter() - t0
    t0 = _time.perf_counter()
    flush_outs()
    if timing is not None:
        timing["readback_s"] += _time.perf_counter() - t0
    if timing is not None:
        log(
            "fold pass timing: "
            + " ".join(f"{k}={v:.2f}" for k, v in timing.items())
        )
        sys_mod = __import__("sys")
        print(
            "[fold-timing] "
            + " ".join(f"{k}={v:.2f}" for k, v in timing.items()),
            file=sys_mod.stderr, flush=True,
        )
    return results


def ens_sharded_fold_fn(static: dict, mesh: Mesh, K: int):
    """Fold program with the K-member ensemble SHARDED over the mesh "ens"
    axis (the reference's second parallel axis, `foreach(k) %:%
    foreach(t)`, R/SHARP.R:554) — not just vmapped inside one chip.

    Each ens shard projects and clusters its K/n_ens members against its
    column slice of the stacked RP operand (member-major (genes, K*p)
    layout makes the column shards contiguous member groups), then ONE
    all_gather of the per-member label/score planes along "ens"
    reassembles the (n_pad, K) ensemble in member order and wMetaC runs
    replicated — identical on every shard, so its outputs are
    ens-replicated by construction. Collectives carry O(n_pad * K) ints,
    never the (n_pad, genes) block.

    Returns a function (X_folds, masks, n_reals, R_all, logf) ->
    FoldSummary batched over the leading fold axis, for use under
    jax.jit with in/out shardings over `mesh`.
    """
    import jax.numpy as jnp

    from jax.sharding import PartitionSpec as P

    from sharp_tpu.core.block import cluster_block_ensemble
    from sharp_tpu.core.wmetac import wmetac

    n_ens = mesh.shape["ens"]
    if K % n_ens:
        raise ValueError(f"ensize_K={K} must divide over ens={n_ens}")
    K_local = K // n_ens
    blk_keys = ("minN", "ncand", "nc_pad", "sil_thre", "height_Ntimes",
                "linkage_backend", "hmethod")
    blk_st = {k: static[k] for k in blk_keys}
    maxN = static["maxN"]
    nc_pad = static["nc_pad"]

    def local_program(X, mask, n_real, R_local, logf):
        blk = cluster_block_ensemble(
            X, mask, n_real, R_local, jnp.asarray(maxN), logf,
            K=K_local, **blk_st,
        )
        # reassemble the full ensemble in member order: shard e holds
        # members [e*K_local, (e+1)*K_local)
        lab_g = jax.lax.all_gather(blk.labels, "ens")     # (n_ens, n, K_l)
        labels = jnp.moveaxis(lab_g, 0, 1).reshape(X.shape[0], K)
        k_per = jax.lax.all_gather(blk.k_per, "ens").reshape(K)
        maxsil = jax.lax.all_gather(blk.maxsil, "ens").reshape(K)
        mean_proj = jax.lax.pmean(blk.mean_proj, "ens")
        wres = wmetac(
            labels, mask, n_real, jnp.asarray(maxN),
            K=K, nc_pad=nc_pad, allc_pad=static["allc_pad"],
            meta_minN=static["minN"], meta_ncand=static["ncand"],
            sil_thre=0.0, height_Ntimes=static["height_Ntimes"],
            hmethod=static["hmethod"],
            linkage_backend=static["linkage_backend"],
        )
        oh = jax.nn.one_hot(wres.finalC, nc_pad, dtype=jnp.float32)
        oh = oh * mask[:, None].astype(jnp.float32)
        cent_sum = jnp.dot(
            oh.T, mean_proj, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return FoldSummary(
            finalC=wres.finalC,
            n_meta=wres.n_meta,
            cent_sum=cent_sum,
            counts=jnp.sum(oh, axis=0),
            mean_proj=mean_proj,
            x0=wres.x0,
            k_per=k_per,
            maxsil=maxsil,
            overflow=wres.overflow,
        )

    def sharded_fn(X_folds, masks, n_reals, R_all, logf):
        def per_shard(Xs, ms, ns, Rs, lf):
            return jax.vmap(
                lambda X, m, n: local_program(X, m, n, Rs, lf)
            )(Xs, ms, ns)

        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P(None, "ens"), P()),
            out_specs=P("data"),
            check_vma=False,
        )(X_folds, masks, n_reals, R_all, logf)

    return sharded_fn


def process_folds_sharded(
    X_folds: np.ndarray,     # (T, B, genes)
    n_reals: np.ndarray,     # (T,)
    R_all: jax.Array,        # (genes, K*p)
    cfg: SharpConfig,
    logf: bool,
    mesh: Mesh,
) -> List[dict]:
    """Run all folds data-parallel over `mesh` and gather host summaries."""
    T, B, genes = X_folds.shape
    ndata = mesh.shape["data"]
    Tpad = ((T + ndata - 1) // ndata) * ndata
    if Tpad != T:
        # dummy folds replicate fold 0 (cheap, numerically safe, discarded)
        reps = Tpad - T
        X_folds = np.concatenate(
            [X_folds, np.repeat(X_folds[:1], reps, axis=0)], axis=0
        )
        n_reals = np.concatenate([n_reals, np.repeat(n_reals[:1], reps)])
    masks = (
        np.arange(B)[None, :] < n_reals[:, None]
    )

    static = fold_static_args(cfg)
    n_ens = mesh.shape.get("ens", 1)
    data_sh = NamedSharding(mesh, P("data"))
    repl_sh = NamedSharding(mesh, P())
    if n_ens > 1 and cfg.ensize_K % n_ens == 0:
        # ensemble members sharded over "ens" (R_all column-sharded),
        # folds over "data"
        fn = ens_sharded_fold_fn(static, mesh, cfg.ensize_K)
        rp_sh = NamedSharding(mesh, P(None, "ens"))
        jfn = jax.jit(
            fn,
            in_shardings=(data_sh, data_sh, data_sh, rp_sh, repl_sh),
            out_shardings=data_sh,
        )
    else:
        fn = _batched_fold_fn(static)
        jfn = jax.jit(
            fn,
            in_shardings=(data_sh, data_sh, data_sh, repl_sh, repl_sh),
            out_shardings=data_sh,
        )
    out: FoldSummary = jfn(
        jnp.asarray(X_folds),
        jnp.asarray(masks),
        jnp.asarray(n_reals),
        R_all,
        jnp.asarray(logf),
    )
    # one leaf: program completion is atomic
    jax.block_until_ready(out.n_meta)

    results = summaries_to_host(out, n_reals[:T], cfg.forview)
    log(
        f"sharded fold pass: {T} folds over {ndata} data shards"
        + (f" x {n_ens} ens shards" if n_ens > 1 else "")
    )
    return results
