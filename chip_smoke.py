"""Smoke test of the clustering engine on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the mesh phases only

One process drives the card(s); a second JAX process on the same card
would fail for want of memory, so the GPU test lane runs in-process.

Phases (one card), each printing its wall time or its failure; every
phase runs, and any failure exits non-zero with no result line:
  1. device check: the platform is `gpu`; prints nvidia-smi's name and
     power limit.
  2. linkage parity at pads 2048 and 1024: the routed Ward backend
     against the f32 serial reference `ward_linkage` on one distance
     matrix computed on the card at Precision.HIGHEST; merges must be
     structurally valid and every valid cut (k = 2 .. 40) identical. The
     Pallas-Triton cut-replay kernel must equal XLA's `cutree_multi` bit
     for bit (n_pad 2048 and 1024, ncand 39, nc_pad 48).
  3. small tier: `sharp()` on 479 cells x 27,998 genes, 7 planted types,
     K=15 — ARI >= 0.9 against the planted labels and >= 0.95 against
     the same seed run on this process's CPU device. The RP projection
     has no precision set, so on the card it runs in TF32 while the CPU
     runs full f32: the two runs are compared by ARI, not bit for bit.
  4. large tier: `sharp()` on 65,536 cells x 27,998 genes, 12 types,
     K=5, p=256, 2,000-cell folds — ARI >= 0.95.
  5. out of core: `sharp_unlimited()` over 2 SBLK blocks of 50,000 cells
     x 27,998 genes at 2,048 nonzeros per cell, written from a seed under
     `.cache/` — ARI >= 0.95; a second run resumes from the manifest
     with identical labels.
  6. the `gpu`-marked tests (tests/test_gpu_device.py) through
     `pytest.main` in this process.

`--four-cards`: `sharp_unlimited(..., n_devices=4)` over 4 full-shape
blocks and `sharp()` on the large tier with `n_devices=4`, each compared
bit for bit with `n_devices=1` on the same data.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

# the card for the pipeline, the host CPU for the reference run of phase 3
os.environ["JAX_PLATFORMS"] = "cuda,cpu"

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402

GENES = 27998
BLOCK = 50000
NNZ = 2048
KNOBS = dict(rN_seed=7, ensize_K=5, reduced_ndim=256, partition_ncells=2000,
             dtype_compute="bfloat16", forview=False)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    """Decorator: run, time and report one phase."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s"
                  + (f": {out}" if out else ""), flush=True)
            return out
        return run
    return wrap


def ari(a, b):
    from sharp_tpu.analysis.ari import ari as _ari

    return float(_ari(np.asarray(a), np.asarray(b)))


@phase("device")
def device_check():
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found {devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    return f"{len(devs)} x {devs[0].device_kind}"


@phase("linkage parity")
def linkage_parity():
    import jax
    import jax.numpy as jnp

    from sharp_tpu.ops.cutree_pallas import cutree_multi_pallas
    from sharp_tpu.ops.distance import pearson_distance
    from sharp_tpu.ops.linkage import (
        cutree_multi,
        resolve_linkage_backend,
        validate_merge_sequence,
        ward_linkage,
        ward_linkage_deferred,
        ward_linkage_rnn,
    )

    backend = resolve_linkage_backend("auto")
    run_backend = {
        "xla": ward_linkage_deferred,
        "rnn": ward_linkage_rnn,
        "rnn_bf16": lambda d: ward_linkage_rnn(d, store_dtype=jnp.bfloat16),
    }[backend]
    report = []
    for n_pad, n_real in ((2048, 2000), (1024, 1000)):
        rng = np.random.default_rng(n_pad)
        types = rng.integers(0, 12, n_real)
        cents = rng.normal(size=(12, 256)) * 3.0
        X = np.zeros((n_pad, 256), np.float32)
        X[:n_real] = cents[types] + rng.normal(size=(n_real, 256))
        mask = jnp.asarray(np.arange(n_pad) < n_real)
        # one D for both sides: upstream rounding cannot flip a near tie
        D = pearson_distance(jnp.asarray(X), mask)
        ref = ward_linkage(D)
        got = run_backend(D)
        for tag, link in (("reference", ref), (backend, got)):
            errs = validate_merge_sequence(link.merges, link.heights,
                                           n_real, n_pad)
            check(not errs, f"{tag} at {n_pad}: {errs}")
        kw = dict(minN=2, ncand=39, nc_pad=48)
        nr, mx = jnp.asarray(n_real), jnp.asarray(40)
        c_ref = cutree_multi(ref.merges, nr, mask, mx, **kw)
        c_got = cutree_multi(got.merges, nr, mask, mx, **kw)
        k_ok = np.asarray(c_ref.valid)
        check(np.array_equal(k_ok, np.asarray(c_got.valid)),
              f"{backend} valid cuts differ from the reference at {n_pad}")
        # every valid cut k = 2 .. 40, label for label
        lab_ref = np.asarray(c_ref.labels)[k_ok]
        lab_got = np.asarray(c_got.labels)[k_ok]
        bad = [int(k) for k, a, b in zip(2 + np.flatnonzero(k_ok), lab_ref,
                                         lab_got) if not np.array_equal(a, b)]
        check(not bad, f"{backend} cuts differ from the reference at "
                       f"{n_pad}, k = {bad}")
        c_ker = cutree_multi_pallas(got.merges, nr, mask, mx, **kw)
        for field, a, b in zip(c_got._fields, c_got, c_ker):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  f"cut kernel {field} differs from cutree_multi at {n_pad}")
        jax.block_until_ready(c_ker)
        report.append(f"{n_pad}: {backend}, {int(k_ok.sum())} cuts "
                      "identical, cut kernel bit-equal")
    return "; ".join(report)


def planted_dense(n, n_types, seed, chunk=8192):
    """(n, GENES) TPM-like planted expression generated on the card in
    chunks (the bench's design: lognormal base, signed DE programs,
    multiplicative noise, dropout, library-size scaling)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    kb, kde, ks, ky = jax.random.split(key, 4)
    base = jnp.exp(1.0 + jax.random.normal(kb, (GENES,)))
    de = jax.random.uniform(kde, (GENES,)) < 0.35
    signs = jax.random.choice(ks, jnp.asarray([-1.0, 1.0]),
                              shape=(n_types, GENES))
    tm = base[None] * jnp.where(de[None], 2.0 ** (signs * 6.0), 1.0)
    y = np.asarray(jax.random.randint(ky, (n,), 0, n_types))

    @jax.jit
    def gen(k, yy):
        kn, kd = jax.random.split(k)
        X = tm[yy] * jnp.exp(0.3 * jax.random.normal(kn, (chunk, GENES)))
        X = X * (jax.random.uniform(kd, (chunk, GENES)) > 0.2)
        return X / jnp.sum(X, axis=-1, keepdims=True) * 1e6

    X = np.empty((n, GENES), np.float32)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        yy = np.zeros(chunk, y.dtype)
        yy[:m] = y[c0:c0 + m]
        X[c0:c0 + m] = np.asarray(
            gen(jax.random.fold_in(key, c0), jnp.asarray(yy))
        )[:m]
    return X, y


@phase("small tier")
def small_tier():
    import jax

    from synth import make_tpm_like

    from sharp_tpu import sharp

    X, y = make_tpm_like(n_cells=479, n_genes=GENES, n_types=7, seed=5)
    kw = dict(rN_seed=2103, ensize_K=15, exp_type="TPM")
    res = sharp(X, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu = sharp(X, **kw)
    a_true = ari(y, res.pred_clusters)
    a_cpu = ari(res_cpu.pred_clusters, res.pred_clusters)
    check(a_true >= 0.9, f"small tier ARI vs planted {a_true:.4f} < 0.9")
    check(a_cpu >= 0.95, f"small tier ARI vs the CPU run {a_cpu:.4f} < 0.95")
    return (f"ARI vs planted {a_true:.4f}, vs CPU {a_cpu:.4f}, "
            f"{res.N_pred_cluster} clusters")


def large_tier_data():
    return planted_dense(65536, 12, seed=123)


@phase("large tier")
def large_tier(X, y):
    from sharp_tpu import sharp

    t0 = time.perf_counter()
    res = sharp(X, **KNOBS)
    secs = time.perf_counter() - t0
    a = ari(y, res.pred_clusters)
    check(a >= 0.95, f"large tier ARI {a:.4f} < 0.95")
    return (f"ARI {a:.4f}, {res.N_pred_cluster} clusters, sharp() "
            f"{secs:.1f} s including compilation")


def sblk_blocks(n_blocks):
    """Directory of `n_blocks` full-shape SBLK blocks (the bench's
    API-path dataset, generated from a seed on first use) and their
    planted labels."""
    import bench

    blocks = [BLOCK] * n_blocks
    n_types = 12
    ddir = bench._api_dataset_dir(sum(blocks), GENES, n_types, NNZ)
    os.makedirs(ddir, exist_ok=True)
    tm, top, n_top = bench._api_type_means(GENES, n_types, NNZ)
    for bi, bn in enumerate(blocks):
        if not os.path.exists(os.path.join(ddir, f"block_{bi:05d}.sblk")):
            bench._api_gen_block(ddir, bi, bn, GENES, NNZ, tm, top, n_top)
    y = np.concatenate([bench._api_block_y(bi, bn, n_types)
                        for bi, bn in enumerate(blocks)])
    return ddir, y


@phase("out of core")
def out_of_core():
    from sharp_tpu import sharp_unlimited
    from sharp_tpu.utils.cache import local_cache_dir

    t0 = time.perf_counter()
    ddir, y = sblk_blocks(2)
    gen_s = time.perf_counter() - t0
    mdir = local_cache_dir("chip_smoke", "manifest")
    shutil.rmtree(mdir)
    os.makedirs(mdir)
    t0 = time.perf_counter()
    first = sharp_unlimited(ddir, manifest_dir=mdir, **KNOBS)
    first_s = time.perf_counter() - t0
    entries = sorted(os.listdir(mdir))
    check(len(entries) == 2, f"manifest holds {entries}, expected 2 blocks")
    stamps = [os.stat(os.path.join(mdir, e)).st_mtime_ns for e in entries]
    t0 = time.perf_counter()
    again = sharp_unlimited(ddir, manifest_dir=mdir, **KNOBS)
    again_s = time.perf_counter() - t0
    check(stamps == [os.stat(os.path.join(mdir, e)).st_mtime_ns
                     for e in entries], "resume rewrote the manifest")
    check(np.array_equal(first.pred_clusters, again.pred_clusters),
          "resumed labels differ")
    a = ari(y, first.pred_clusters)
    check(a >= 0.95, f"out-of-core ARI {a:.4f} < 0.95")
    return (f"ARI {a:.4f}, {first.N_pred_cluster} clusters; data "
            f"{gen_s:.1f} s, first run {first_s:.1f} s, resumed run "
            f"{again_s:.1f} s with identical labels")


@phase("gpu test lane")
def gpu_lane():
    import pytest

    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
        os.path.join(ROOT, "tests", "test_gpu_device.py"),
    ])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")
    return None


@phase("four cards: out of core")
def four_cards_out_of_core():
    from sharp_tpu import sharp_unlimited

    ddir, y = sblk_blocks(4)
    one = sharp_unlimited(ddir, manifest_dir=None, resume=False,
                          n_devices=1, **KNOBS)
    four = sharp_unlimited(ddir, manifest_dir=None, resume=False,
                           n_devices=4, **KNOBS)
    check(np.array_equal(one.pred_clusters, four.pred_clusters),
          "n_devices=4 labels differ from n_devices=1")
    return f"bit-equal labels, ARI {ari(y, four.pred_clusters):.4f}"


@phase("four cards: large tier")
def four_cards_large():
    from sharp_tpu import sharp

    X, y = large_tier_data()
    one = sharp(X, n_devices=1, **KNOBS)
    four = sharp(X, n_devices=4, **KNOBS)
    check(np.array_equal(one.pred_clusters, four.pred_clusters),
          "n_devices=4 labels differ from n_devices=1")
    return f"bit-equal labels, ARI {ari(y, four.pred_clusters):.4f}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phases")
    args = ap.parse_args()

    import jax

    from sharp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    device_check()
    if args.four_cards:
        check(len(jax.devices()) == 4,
              f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
        four_cards_out_of_core()
        four_cards_large()
    else:
        failures = []
        for run in (linkage_parity, small_tier,
                    lambda: large_tier(*large_tier_data()), out_of_core,
                    gpu_lane):
            try:
                run()
            except SmokeFailure as e:
                print(f"FAILED: {e}", flush=True)
                failures.append(str(e))
        check(not failures, f"{len(failures)} phases failed: {failures}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except (SmokeFailure, RuntimeError, ImportError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
