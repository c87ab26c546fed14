"""SHARP benchmark: cells/s through the full clustering pipeline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Baseline: the reference publishes a single per-cell rate — the Wang
pancreas run, 479 cells in 0.16285 min = 49.0 cells/s on an i5-7300U
(reference README.md:97-103). `vs_baseline` is our cells/s over that rate.

Workload: the reference's largest demonstrated configuration — 1,306,127
cells x 27,998 genes as ~50k-cell blocks (README.md:287-303) — run through
the production two-level path: per-fold ensemble + wMetaC, per-block
sMetaC fuse, then one global sMetaC over block-cluster summaries (the
SHARP_unlimited structure, minus disk I/O: synthetic expression is
generated ON DEVICE so the bench measures the compute path).

Quality is a HARD GATE (a device numerics regression once shipped a
green benchmark with ARI -0.0):
  * before timing, the routed linkage backends must produce structurally
    valid merge sequences on the device at the fold pad and at 1024
    (`validate_merge_sequence`), else exit 2;
  * after the run, ARI vs the planted types must be >= SHARP_BENCH_MIN_ARI
    (default 0.80 at the 1.3M scale, where smetac_range's minN floor
    deliberately over-clusters; 0.95 at the 65k quick scale), else exit 1.

Env knobs: SHARP_BENCH_CELLS (default 1306127), SHARP_BENCH_BLOCK (50000),
SHARP_BENCH_GENES, SHARP_BENCH_TYPES (38 at >= 1e6 cells — the reference's
1.3M dataset is mouse organogenesis with 38 types — else 12),
SHARP_BENCH_K, SHARP_BENCH_P, SHARP_BENCH_FOLD, SHARP_BENCH_MIN_ARI,
SHARP_BENCH_QUICK=1 (65,536-cell single-block configuration),
SHARP_BENCH_PROFILE=<dir> (jax profiler trace), SHARP_BENCH_STAGES=0
to skip the per-stage breakdown (default ON), SHARP_BENCH_API=0 to skip
the shipped-API (sharp_unlimited over SBLK files) measurement,
SHARP_BENCH_API_NNZ (2048 nonzero genes/cell in the on-disk dataset),
SHARP_BENCH_API_DIR (dataset cache root, default
<checkout>/.cache/benchdata).

Every JSON line names the device: platform, device_kind, device count and
the card's power limit as nvidia-smi reports it.

TIME-BUDGET CONTRACT (the r03/r04 artifacts died to the driver's clock):
the watchdog bounds the WHOLE bench — both children, all retries — by one
deadline, SHARP_BENCH_TIMEOUT seconds from launch (default 1140), and
always lands at least one JSON line on stdout:
  * the compute-path line is printed (flushed) the MOMENT the compute
    child returns — a later kill cannot lose it;
  * the merged line (compute detail + api_path) is printed after the API
    child, so a last-parseable-line reader gets the fullest result that
    existed when the clock ran out.
The API child receives only the time remaining after compute and is
skipped (detail.api_path.skipped) when < 240 s remain. The API
measurement itself streams SHARP_BENCH_API_BLOCKS (default 4) full-shape
50k-cell blocks of the flagship dataset — per-block cost is constant, so
the subset is an honest sample — and reports measured_blocks /
total_blocks / extrapolated_full_seconds explicitly. SHARP_BENCH_API_FULL=1
streams all 26 blocks (manual runs only). Dataset blocks are generated on
demand and cached, so the subset run never pays the full ~21 GB
generation. The parent process stays off JAX and runs its children one
after another, so only one process holds the card at a time.
"""

import json
import os
import sys
import time

import numpy as np


def _bench_env():
    """Shared workload parameters (compute + API children must agree)."""
    quick = os.environ.get("SHARP_BENCH_QUICK") == "1"
    n_cells = int(
        os.environ.get("SHARP_BENCH_CELLS", 65536 if quick else 1306127)
    )
    n_genes = int(os.environ.get("SHARP_BENCH_GENES", 27998))
    default_types = 12 if n_cells < 1e6 else 38
    n_types = int(os.environ.get("SHARP_BENCH_TYPES", default_types))
    K = int(os.environ.get("SHARP_BENCH_K", 5))
    p = int(os.environ.get("SHARP_BENCH_P", 256))
    fold = int(os.environ.get("SHARP_BENCH_FOLD", 2000))
    block_cells = int(os.environ.get("SHARP_BENCH_BLOCK", 50000))
    min_ari = float(
        os.environ.get(
            "SHARP_BENCH_MIN_ARI", 0.95 if n_cells < 1e6 else 0.80
        )
    )
    # block partition (reference: 25 x 50,000 + 56,127, README.md:289)
    blocks = []
    left = n_cells
    while left > 0:
        take = block_cells if left >= 2 * block_cells else left
        blocks.append(take)
        left -= take
    return dict(
        n_cells=n_cells, n_genes=n_genes, n_types=n_types, K=K, p=p,
        fold=fold, min_ari=min_ari, blocks=blocks,
    )


def device_info() -> dict:
    """Platform, device kind, device count and — on an NVIDIA card — the
    power limit nvidia-smi reports, for every JSON line."""
    import shutil
    import subprocess

    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    if dev.platform == "gpu" and shutil.which("nvidia-smi"):
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
        ).stdout.strip()
    return info


def _free(*objs):
    """Release device buffers NOW (don't wait for GC): multi-GB
    compute-path buffers still resident when later stages allocate can
    exhaust device memory."""
    import jax

    for o in objs:
        for leaf in jax.tree.leaves(o):
            if hasattr(leaf, "delete"):
                try:
                    leaf.delete()
                except Exception:
                    pass


def parity_precheck(pearson_distance, B):
    """On-device structural validation of the ladder backends at the fold
    pad B, and of the routed backend at the 1024 pad of the meta problems
    (wMetaC/sMetaC)."""
    import jax
    import jax.numpy as jnp

    from sharp_tpu.ops.linkage import (
        resolve_linkage_backend,
        validate_merge_sequence,
        ward_linkage_rnn,
    )

    def make_D(n_pad):
        rng = np.random.default_rng(11)
        n_real = n_pad - 48
        types = rng.integers(0, 12, n_real)
        cents = rng.normal(size=(12, 64)) * 3.0
        X = np.zeros((n_pad, 64), np.float32)
        X[:n_real] = cents[types] + rng.normal(size=(n_real, 64))
        mask = np.arange(n_pad) < n_real
        return pearson_distance(jnp.asarray(X), jnp.asarray(mask)), n_real

    problems = {}
    backend = resolve_linkage_backend("auto")
    D, n_real = make_D(B)
    for tag, st in (("rnn_f32", None), ("rnn_bf16", jnp.bfloat16)):
        res = jax.block_until_ready(ward_linkage_rnn(D, store_dtype=st))
        errs = validate_merge_sequence(res.merges, res.heights, n_real, B)
        if errs:
            problems[tag] = errs
    if backend.startswith("rnn"):
        Dm, n_real_m = make_D(1024)
        st = jnp.bfloat16 if backend == "rnn_bf16" else None
        res = jax.block_until_ready(ward_linkage_rnn(Dm, store_dtype=st))
        errs = validate_merge_sequence(res.merges, res.heights, n_real_m, 1024)
        if errs:
            problems[f"{backend}_1024"] = errs
    return backend, problems


def main():
    env = _bench_env()
    n_cells, n_genes, n_types = (
        env["n_cells"], env["n_genes"], env["n_types"]
    )
    K, p, fold, min_ari = env["K"], env["p"], env["fold"], env["min_ari"]
    blocks = env["blocks"]

    import jax

    from sharp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp

    from sharp_tpu.config import resolve_config, pad_dim
    from sharp_tpu.core.fold import fold_program, fold_static_args
    from sharp_tpu.core.large import fold_sizes, fuse_blocks, summaries_to_host
    from sharp_tpu.ops.distance import pearson_distance
    from sharp_tpu.ops.rp import ensemble_rp_matrix, rp_project_ensemble
    from sharp_tpu.parallel.streaming import global_block_fuse
    from sharp_tpu.types import finalize_labels
    from sharp_tpu.analysis.ari import ari

    cfg = resolve_config(
        n_cells, n_genes, ensize_K=K, reduced_ndim=p,
        partition_ncells=fold, rN_seed=7, dtype_compute="bfloat16",
        forview=False,
    )

    # (block_id, fold_size) list, global fold order
    fold_plan = []
    for bi, bn in enumerate(blocks):
        for sz in fold_sizes(bn, cfg.partition_ncells):
            fold_plan.append((bi, sz))
    T = len(fold_plan)
    B = pad_dim(max(sz for _, sz in fold_plan))
    static = fold_static_args(cfg)

    # --- hardware parity pre-check (refuse to publish invalid numbers) ---
    backend, problems = parity_precheck(pearson_distance, B)
    if problems:
        print(json.dumps({
            "metric": "cells_per_second_end_to_end",
            "value": 0.0,
            "unit": "cells/s",
            "vs_baseline": 0.0,
            "detail": {
                "error": "linkage parity pre-check FAILED on device",
                "problems": problems,
                **device_info(),
            },
        }))
        sys.exit(2)

    # --- on-device synthetic expression ---------------------------------
    # lognormal base profile, equidistant signed DE programs (same design
    # as tests/synth.py), dropout, TPM scaling
    kroot = jax.random.PRNGKey(123)
    kb, kde, ksign = jax.random.split(kroot, 3)
    base = jnp.exp(1.0 + 1.0 * jax.random.normal(kb, (n_genes,)))
    de_mask = jax.random.uniform(kde, (n_genes,)) < 0.35
    signs = jax.random.choice(
        ksign, jnp.asarray([-1.0, 1.0]), shape=(n_types, n_genes)
    )
    lfc = 6.0
    type_means = base[None, :] * jnp.where(
        de_mask[None, :], 2.0 ** (signs * lfc), 1.0
    )

    def gen_fold(t, n_real):
        kf = jax.random.fold_in(jax.random.PRNGKey(999), t)
        k1, k2, k3 = jax.random.split(kf, 3)
        y = jax.random.randint(k1, (B,), 0, n_types)
        noise = jnp.exp(0.3 * jax.random.normal(k2, (B, n_genes)))
        keep = jax.random.uniform(k3, (B, n_genes)) > 0.2
        X = type_means[y] * noise * keep
        X = X / jnp.maximum(jnp.sum(X, axis=1, keepdims=True), 1e-9) * 1e6
        return X.astype(jnp.float32), y

    gen_fold_j = jax.jit(gen_fold)

    R_all = ensemble_rp_matrix(
        jax.random.PRNGKey(7), K, n_genes, p, dtype=jnp.bfloat16
    )

    # 16 folds/call: the linkage rounds are dispatch-latency-bound, so a
    # bigger vmapped batch amortizes them (19.0 vs 29.3 ms/fold at 4)
    GROUP = int(os.environ.get("SHARP_BENCH_GROUP", 16))
    GROUP = min(GROUP, T)

    def run_group(Xg, masks, nrs):
        def one(X, m, nr):
            return fold_program(
                X, m, nr, R_all, jnp.asarray(True), None,
                has_indN=False, **static,
            )

        return jax.vmap(one)(Xg, masks, nrs)

    run_group_j = jax.jit(run_group)

    def gen_group(g0, gsizes):
        Xs, ys, ms = [], [], []
        for gi, sz in enumerate(gsizes):
            X, y = gen_fold_j(g0 + gi, sz)
            Xs.append(X)
            ys.append(y)
            ms.append(jnp.arange(B) < sz)
        return jnp.stack(Xs), ys, jnp.stack(ms)

    # --- warmup / compile ------------------------------------------------
    sync = jax.block_until_ready

    g_sizes0 = [sz for _, sz in fold_plan[:GROUP]]
    g_sizes0 += [g_sizes0[0]] * (GROUP - len(g_sizes0))
    Xg, ys, ms = gen_group(0, g_sizes0)
    t0 = time.time()
    sync(run_group_j(Xg, ms, jnp.asarray(g_sizes0, jnp.int32)))
    compile_s = time.time() - t0

    # --- per-stage breakdown on one group (default ON so every result
    # carries the profile; SHARP_BENCH_STAGES=0 to skip the extra
    # compiles) ----------------------------------------------------------
    stages = {}
    if os.environ.get("SHARP_BENCH_STAGES", "1") == "1":
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        def timed(f, *a, r=3):
            sync(f(*a))
            t0 = time.time()
            for _ in range(r):
                out = f(*a)
            sync(out)
            return (time.time() - t0) / r

        rp_j = jax.jit(jax.vmap(
            lambda X: rp_project_ensemble(
                jnp.log2(1.0 + X), R_all, K=K
            )
        ))
        proj = rp_j(Xg)
        dist_j = jax.jit(jax.vmap(jax.vmap(
            lambda Z: pearson_distance(Z, ms[0])
        )))
        D4 = dist_j(proj)
        link_j = jax.jit(jax.vmap(jax.vmap(ward_linkage_rnn)))
        stages = {
            "rp_project_s": round(timed(rp_j, Xg), 4),
            "distance_s": round(timed(dist_j, proj), 4),
            "linkage_s": round(timed(link_j, D4), 4),
            "fold_program_total_s": round(
                timed(
                    run_group_j, Xg, ms,
                    jnp.asarray(g_sizes0, jnp.int32),
                ), 4,
            ),
            "per_group_folds": GROUP,
        }
        # the breakdown's intermediates (~1.5 GB at production shapes)
        # must not stay resident through the timed run
        _free(proj, D4)
        del proj, D4, rp_j, dist_j, link_j

    # --- timed run -------------------------------------------------------
    # synthetic generation is NOT part of the measured pipeline: each
    # group's expression tensor is materialized and synced before its
    # clustering pass is timed (real input arrives via the streaming
    # loader, which overlaps I/O with compute)
    profile_dir = os.environ.get("SHARP_BENCH_PROFILE")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    truth = []
    fold_pass_s = 0.0
    gen_s = 0.0
    block_frs = [[] for _ in blocks]

    # summary + truth readbacks are flushed in 8-group batches: each
    # device-to-host pull is a round trip, so per-group pulls would idle
    # the device between groups
    pend_plans = []  # (plan, ys (GROUP, B) device)
    pend_outs = []

    def flush_pending():
        if not pend_outs:
            return
        merged = (
            pend_outs[0]
            if len(pend_outs) == 1
            else jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0), *pend_outs
            )
        )
        ys_host = np.asarray(
            jnp.concatenate([y for _, y in pend_plans], axis=0)
        )
        lane_sizes = []
        for plan, _ in pend_plans:
            lane_sizes += [sz for _, sz in plan]
            lane_sizes += [0] * (GROUP - len(plan))
        # selective bulk pull (skips the O(B x p) view planes)
        frs = summaries_to_host(merged, lane_sizes, False)
        li = 0
        for plan, _ in pend_plans:
            for gi, (bi, sz) in enumerate(plan):
                truth.append(ys_host[li + gi][:sz])
                block_frs[bi].append(frs[li + gi])
            li += GROUP
        pend_plans.clear()
        pend_outs.clear()

    for g0 in range(0, T, GROUP):
        plan = fold_plan[g0 : g0 + GROUP]
        gsizes = [sz for _, sz in plan]
        G = len(gsizes)
        pad_sizes = gsizes + [gsizes[0]] * (GROUP - G)
        tg = time.time()
        Xg, ys, ms = gen_group(g0, pad_sizes)
        jax.block_until_ready(Xg)
        gen_s += time.time() - tg
        t0 = time.time()
        out = run_group_j(Xg, ms, jnp.asarray(pad_sizes, jnp.int32))
        # one leaf: the XLA program completes atomically
        jax.block_until_ready(out.n_meta)
        fold_pass_s += time.time() - t0
        pend_plans.append((plan, jnp.stack(ys)))
        pend_outs.append(out)
        if len(pend_outs) >= 8:
            flush_pending()
    flush_pending()
    if profile_dir:
        jax.profiler.stop_trace()
    # everything downstream works on host summaries — release the multi-GB
    # fold-pass device buffers before the fuse programs compile/run
    _free(Xg, ms, out)
    del Xg, ms, out

    # --- per-block sMetaC fuses, batched (one vmapped smetac per shape
    # bucket; the r02 bench paid a full XLA recompile inside the timed
    # region whenever blocks straddled an NC_pad bucket) -----------------
    t0 = time.time()
    fuse_blocks(block_frs, cfg)  # warm every shape bucket (compile)
    compile_s += time.time() - t0
    t0 = time.time()
    fused = fuse_blocks(block_frs, cfg)
    block_summaries = []
    block_labels = []
    for fres in fused:
        uniq = np.unique(fres.labels)
        block_summaries.append((fres.cents[uniq], fres.counts[uniq]))
        block_labels.append(np.searchsorted(uniq, fres.labels))
    block_fuse_s = time.time() - t0

    # --- global fuse over block summaries --------------------------------
    # (single block: the block consensus IS the final clustering, as the
    # reference's SHARP_unlimited degrades to plain SHARP for one block)
    if len(blocks) == 1:
        t0 = time.time()
        labels = finalize_labels(
            block_labels[0].astype(np.int32), merge_tiny=True
        )
        global_fuse_s = time.time() - t0
    else:
        # warm the fuse program's trace/compile (one-time per-process
        # cost), then time it
        t0 = time.time()
        global_block_fuse(block_summaries, cfg)
        compile_s += time.time() - t0
        t0 = time.time()
        tf, remap, offsets, order, meta_sizes = global_block_fuse(
            block_summaries, cfg
        )
        parts = [
            remap[tf[offsets[bi] + block_labels[bi]]]
            for bi in range(len(blocks))
        ]
        raw = np.concatenate(parts).astype(np.int32)
        labels = finalize_labels(raw, merge_tiny=True)
        global_fuse_s = time.time() - t0

    total_s = fold_pass_s + block_fuse_s + global_fuse_s
    truth = np.concatenate(truth)
    score = ari(truth, labels)
    n_final = len(np.unique(labels))

    def quality_gates(tag, s, k):
        """ARI floor + cluster-count drift bound (two independent gates:
        round-1 shipped 47-clusters-from-12 with ARI -0.0)."""
        msgs = []
        if s < min_ari:
            msgs.append(f"{tag}: ARI {s:.4f} < {min_ari}")
        k_hi = int(np.ceil(1.5 * n_types))
        k_lo = max(2, n_types // 3)
        if k > k_hi:
            msgs.append(
                f"{tag}: {k} clusters found > 1.5x the {n_types} planted"
            )
        if k < k_lo:
            msgs.append(
                f"{tag}: {k} clusters found < {k_lo} (over-merged "
                f"from {n_types} planted)"
            )
        return msgs

    gate_msgs = quality_gates("compute", float(score), int(n_final))

    cells_per_s = n_cells / total_s
    baseline = 479 / 9.771  # reference Wang-pancreas rate (cells/s)
    out = {
        "metric": "cells_per_second_end_to_end",
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / baseline, 1),
        "detail": {
            "n_cells": n_cells,
            "n_genes": n_genes,
            "n_blocks": len(blocks),
            "n_folds": T,
            "n_planted_types": n_types,
            "ensemble_K": K,
            "reduced_dim": p,
            "ari_vs_planted_types": round(float(score), 4),
            "ari_gate_min": min_ari,
            "ari_gate_passed": not gate_msgs,
            "n_clusters_found": int(n_final),
            "linkage_backend": backend,
            "fold_pass_seconds": round(fold_pass_s, 2),
            "block_fuse_seconds": round(block_fuse_s, 2),
            "global_fuse_seconds": round(global_fuse_s, 2),
            "total_seconds": round(total_s, 2),
            "datagen_seconds_untimed": round(gen_s, 2),
            "compile_seconds": round(compile_s, 2),
            **device_info(),
            **({"stages": stages} if stages else {}),
        },
    }
    print(json.dumps(out))
    if gate_msgs:
        sys.stderr.write(
            "QUALITY GATE FAILED: " + "; ".join(gate_msgs) + "\n"
        )
        sys.exit(1)


def _api_dataset_dir(n_cells, G, n_types, keep):
    from sharp_tpu.utils.cache import local_cache_dir

    root = os.environ.get("SHARP_BENCH_API_DIR") or local_cache_dir(
        "benchdata"
    )
    return os.path.join(root, f"v2_{n_cells}_{G}_{n_types}_{keep}")


def _api_type_means(G, n_types, keep):
    """Global type-mean profiles + per-type top-expressed gene supports.

    Deterministic from a fixed seed, so per-block generation is
    independent and cached block files are bit-identical whether
    generated all at once or on demand.
    """
    grng = np.random.default_rng(123)
    base = np.exp(1.0 + grng.standard_normal(G)).astype(np.float32)
    de = grng.uniform(size=G) < 0.35
    signs = grng.choice(
        np.asarray([-1.0, 1.0], np.float32), size=(n_types, G)
    )
    tm = (base * np.where(de, 2.0 ** (signs * 6.0), 1.0)).astype(np.float32)
    # Realistic dropout structure: a cell's nonzero support is mostly
    # its type's TOP-expressed genes (libraries concentrate on high
    # expressors) plus a random tail. Uniformly-random supports make
    # same-type cells share almost no genes and Pearson collapses —
    # real scRNA sparsity is expression-correlated, not uniform.
    n_top = (keep * 3) // 4
    top = np.argsort(-tm, axis=1)[:, :n_top].astype(np.int32)
    return tm, top, n_top


def _api_block_y(bi, bn, n_types):
    """Planted labels for block bi — the generator rng's FIRST draw, so
    labels are recoverable without touching the (possibly huge) data."""
    return np.random.default_rng(1000 + bi).integers(0, n_types, bn)


def _api_gen_block(ddir, bi, bn, G, keep, tm, top, n_top):
    """Generate one SBLK block atomically (tmp + rename)."""
    import scipy.sparse as sp

    from sharp_tpu.io.native import write_sblk

    rng = np.random.default_rng(1000 + bi)
    y = rng.integers(0, tm.shape[0], bn)
    tail = rng.integers(0, G, (bn, keep - n_top), dtype=np.int32)
    cols = np.concatenate([top[y], tail], axis=1)
    cols.sort(axis=1)
    vals = tm[y[:, None], cols] * np.exp(
        0.3 * rng.standard_normal((bn, keep), dtype=np.float32)
    )
    vals *= 1e6 / vals.sum(axis=1, keepdims=True)
    indptr = np.arange(bn + 1, dtype=np.int64) * keep
    csr = sp.csr_matrix((vals.ravel(), cols.ravel(), indptr), shape=(bn, G))
    path = os.path.join(ddir, f"block_{bi:05d}.sblk")
    write_sblk(path + ".tmp", csr, dtype_code=0)
    os.replace(path + ".tmp", path)


def api_bench(blocks, n_genes, n_types, K, p, fold, min_ari, ari,
              sub_blocks=None):
    """Time the shipped sharp_unlimited end-to-end over SBLK blocks.

    Synthetic sparse blocks (planted types, ~SHARP_BENCH_API_NNZ nonzero
    genes/cell — single-cell-like density) are generated ON DEMAND into a
    content-keyed cache dir (per-block files are deterministic and
    independent, so a subset run generates/pays only its own blocks); the
    timed region is the production streaming stack: SBLK load + prefetch
    thread, CSR triplet transfer + on-device densify, fold pass, batched
    block fuses, manifest writes, global sMetaC, size-ordered relabel.

    `sub_blocks` (driver default 4) streams only the first S full-shape
    blocks: per-block cost is constant, so measured cells/s is an honest
    sample, reported with measured_blocks / total_blocks /
    extrapolated_full_seconds. None streams everything.
    """
    import shutil
    import tempfile

    from sharp_tpu.parallel.streaming import sharp_unlimited

    G = n_genes
    keep = int(os.environ.get("SHARP_BENCH_API_NNZ", 2048))
    keep = min(keep, (G * 4) // 5)  # tiny-G (test) configs stay sparse
    full_cells = sum(blocks)
    S = len(blocks) if sub_blocks is None else min(sub_blocks, len(blocks))
    run_blocks = blocks[:S]
    n_cells = sum(run_blocks)
    ddir = _api_dataset_dir(full_cells, G, n_types, keep)
    os.makedirs(ddir, exist_ok=True)

    datagen_s = 0.0
    missing = [
        bi for bi in range(S)
        if not os.path.exists(os.path.join(ddir, f"block_{bi:05d}.sblk"))
    ]
    if missing:
        t0 = time.time()
        tm, top, n_top = _api_type_means(G, n_types, keep)
        for bi in missing:
            _api_gen_block(ddir, bi, blocks[bi], G, keep, tm, top, n_top)
        datagen_s = time.time() - t0

    y = np.concatenate(
        [_api_block_y(bi, bn, n_types) for bi, bn in enumerate(run_blocks)]
    )

    api_kw = dict(
        rN_seed=7, ensize_K=K, reduced_ndim=p, partition_ncells=fold,
        dtype_compute="bfloat16", forview=False, resume=False,
    )
    # warm the API path's compiled programs (the streaming fold fn,
    # densify scatter, per-block + global smetac buckets differ from the
    # compute path's jit signatures) on the first block, untimed — the
    # timed run below measures steady-state like blocks 2..N see.
    # The warm run declares the SAME n_cells as the timed run: declared
    # size drives smetac_range's search width and thus compiled shapes.
    warm_dir = tempfile.mkdtemp(prefix="sharp_bench_apiwarm_")
    run_dir = tempfile.mkdtemp(prefix="sharp_bench_apirun_")
    mdir = tempfile.mkdtemp(prefix="sharp_bench_manifest_")
    compile_s = 0.0
    try:
        os.symlink(
            os.path.join(ddir, "block_00000.sblk"),
            os.path.join(warm_dir, "block_00000.sblk"),
        )
        for bi in range(S):
            name = f"block_{bi:05d}.sblk"
            os.symlink(
                os.path.join(ddir, name), os.path.join(run_dir, name)
            )
        with open(os.path.join(run_dir, "blocks.json"), "w") as fh:
            json.dump(
                {"n_cells": n_cells, "n_genes": G, "n_blocks": S}, fh
            )
        t0 = time.time()
        sharp_unlimited(
            warm_dir, n_cells=n_cells, manifest_dir=None, **api_kw
        )
        compile_s = time.time() - t0
        t0 = time.time()
        res = sharp_unlimited(run_dir, manifest_dir=mdir, **api_kw)
        api_s = time.time() - t0
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
        shutil.rmtree(warm_dir, ignore_errors=True)
        shutil.rmtree(run_dir, ignore_errors=True)

    api_ari = float(ari(y, res.pred_clusters))
    k = int(res.N_pred_cluster)
    if S < len(blocks) and n_cells < 1e6:
        # subset declares < 1e6 cells, so the smetac_range minN floor that
        # justifies the relaxed 0.80 full-scale gate is not tripped —
        # hold the subset to the clean-clustering bar
        min_ari = max(min_ari, 0.95)
    msgs = []
    if api_ari < min_ari:
        msgs.append(f"api: ARI {api_ari:.4f} < {min_ari}")
    if k > int(np.ceil(1.5 * n_types)):
        msgs.append(f"api: {k} clusters found > 1.5x the {n_types} planted")
    detail = {
        "cells_per_s": round(n_cells / api_s, 1),
        "total_seconds": round(api_s, 2),
        "measured_blocks": S,
        "total_blocks": len(blocks),
        "measured_cells": int(n_cells),
        "extrapolated": S < len(blocks),
        "ari_vs_planted_types": round(api_ari, 4),
        "n_clusters_found": k,
        "nnz_per_cell": keep,
        "datagen_seconds_untimed": round(datagen_s, 2),
        "warm_compile_seconds_untimed": round(compile_s, 2),
        "timing": {
            r["stage"]: round(r["seconds"], 2)
            for r in (res.timing or {}).get("stages", [])
        },
    }
    if S < len(blocks):
        detail["extrapolated_full_seconds"] = round(
            api_s * full_cells / n_cells, 1
        )
    return detail, msgs


def main_api():
    """API-path child: the SHIPPED sharp_unlimited over SBLK blocks on
    disk (reference runs 1.3M cells out-of-core from RDS files,
    R/SHARP_unlimited3.R:103-131 — this measures OUR production path,
    I/O, prefetch, sparse device feed, manifest writes and all).

    Runs in its OWN process so its device memory starts clean — launched
    while the compute path's buffers are still resident it can run out
    of device memory."""
    env = _bench_env()

    from sharp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from sharp_tpu.analysis.ari import ari

    if os.environ.get("SHARP_BENCH_API_FULL") == "1":
        sub = None
    else:
        sub = int(os.environ.get("SHARP_BENCH_API_BLOCKS", 4))
    detail, msgs = api_bench(
        env["blocks"], env["n_genes"], env["n_types"], env["K"], env["p"],
        env["fold"], env["min_ari"], ari, sub_blocks=sub,
    )
    detail["gate_passed"] = not msgs
    detail.update(device_info())
    print(json.dumps({"api_path": detail}), flush=True)
    if msgs:
        sys.stderr.write(
            "QUALITY GATE FAILED: " + "; ".join(msgs) + "\n"
        )
        sys.exit(1)


def _run_child(flag, deadline, extra_env=None):
    """Run one bench child; returns (parsed_json | None, rc, stderr_tail).

    The attempt is bounded by the shared `deadline` (wall-clock
    time.time() value), so the bench never outlives its window."""
    import subprocess

    env = dict(os.environ)
    env.update(extra_env or {})
    budget = deadline - time.time()
    if budget < 60:
        return None, -1, "no budget left"
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), flag],
            timeout=budget, capture_output=True, text=True, env=env,
        )
    except subprocess.TimeoutExpired:
        return None, -1, f"timed out after {budget:.0f}s"
    obj = None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                pass
    if obj is not None:
        return obj, proc.returncode, proc.stderr[-2000:]
    err = proc.stderr[-2000:] or f"rc={proc.returncode}, no JSON"
    sys.stderr.write(f"bench {flag} failed (rc={proc.returncode}); "
                     f"stderr tail:\n{err}\n")
    return None, proc.returncode, err


def _watchdog_main():
    """Orchestrate the compute + API children; ALWAYS land a JSON line.

    One TOTAL deadline (SHARP_BENCH_TIMEOUT s from launch, default 1140)
    bounds everything — children, retries, the degradation ladder. The
    compute-path JSON is printed (flushed) the instant the compute child
    returns, so a driver kill during the API phase still finds it; the
    merged line printed at the end wins for last-line parsers.

    Degradation ladder: if the compute child dies,
    retry with halved fold group + stages off, then group=4 — a broken
    optional section can never zero the core number again. The API child
    runs in a fresh process (clean HBM) with only the REMAINING budget;
    its infra failure or a too-small remainder is recorded in
    detail.api_path without failing the bench, but a genuine API
    quality-gate failure (JSON emitted, rc != 0) does propagate."""
    t_start = time.time()
    total = int(os.environ.get("SHARP_BENCH_TIMEOUT", 1140))
    deadline = t_start + total
    base_group = int(os.environ.get("SHARP_BENCH_GROUP", 16))
    ladder = [
        {},
        {"SHARP_BENCH_GROUP": str(max(1, base_group // 2)),
         "SHARP_BENCH_STAGES": "0"},
        {"SHARP_BENCH_GROUP": "4", "SHARP_BENCH_STAGES": "0"},
    ]
    obj, rc, err = None, 1, ""
    for extra in ladder:
        obj, rc, err = _run_child("--compute", deadline - 30, extra)
        if obj is not None:
            if extra:
                obj.setdefault("detail", {})["degraded_env"] = extra
            break
        sys.stderr.write(
            f"compute child failed ({err[-300:]}); degrading: next "
            "ladder step\n"
        )
        if deadline - time.time() < 120:
            break
    if obj is None:
        print(json.dumps({
            "metric": "cells_per_second_end_to_end",
            "value": 0.0,
            "unit": "cells/s",
            "vs_baseline": 0.0,
            "detail": {"error": f"compute bench failed: {err[-500:]}"},
        }), flush=True)
        return 1

    # land the headline NOW — nothing after this point can lose it
    print(json.dumps(obj), flush=True)

    final_rc = rc
    detail = obj.setdefault("detail", {})
    if os.environ.get("SHARP_BENCH_API", "1") == "1":
        remaining = deadline - time.time() - 45
        if remaining < 240:
            detail["api_path"] = {
                "skipped": (
                    f"only {remaining:.0f}s of the {total}s budget remain "
                    "after the compute path"
                )
            }
        else:
            aobj, arc, aerr = _run_child("--api", time.time() + remaining)
            if aobj is not None and "api_path" in aobj:
                ap = aobj["api_path"]
                tot = detail.get("total_seconds")
                if tot and detail.get("n_cells"):
                    ap["cells_per_s_vs_compute"] = round(
                        ap["cells_per_s"] / (detail["n_cells"] / tot), 3
                    )
                detail["api_path"] = ap
                if arc != 0:
                    final_rc = final_rc or arc  # genuine quality failure
            else:
                detail["api_path"] = {
                    "error": f"api child failed: {(aerr or '')[-500:]}"
                }
    # merged line: compute detail + api_path — last JSON line wins
    print(json.dumps(obj), flush=True)
    return final_rc


if __name__ == "__main__":
    if "--compute" in sys.argv or "--child" in sys.argv:
        main()
    elif "--api" in sys.argv:
        main_api()
    else:
        sys.exit(_watchdog_main())
