"""Measure the Ward backends and the cut-replay kernel on the GPU.

The source of the GPU routing in `ops/linkage.resolve_linkage_backend`
and of the choice to replay candidate cuts in `ops/cutree_pallas`
(PERF.md, "Bring-up findings"):

  1. the cut kernel compiled at n_pad 2048 / ncand 39 / nc_pad 48 with
     1, 2, 4 and 8 warps, each compared bit for bit with XLA's
     `cutree_multi` on 80 merge sequences;
  2. each part alone at production widths: cut replay (XLA loop vs
     kernel) and the three Ward backends
     (`ward_linkage_deferred`, `ward_linkage_rnn` f32 and bf16 storage)
     at the fold pad (2048, 16 folds x K=5 = 80 problems) and the meta
     pads (256..1024, 16 problems);
  3. the whole fold program (16 folds x 2048 cells x 27,998 genes, K=5,
     p=256) under each backend and cut replay, which is the number that
     decides, with each variant's fold labels compared by ARI with the
     production routing's.

Run on one GPU from the repo root:

    python scripts/linkage_routing.py [--skip-fold | --breakdown-only]

Prints one JSON line per measurement. `--breakdown-only` instead traces
one fold-program call under the production routing and prints the device
seconds per scope (ladder, tail, cut replay, sweep, wMetaC, ...).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(f, *args, reps=3):
    """Seconds per call after one warm call, all ending in
    block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps


def clustered_distances(n_pad, n_real, lanes, seed, p=64, types=12):
    import jax.numpy as jnp

    from sharp_tpu.ops.distance import pearson_distance

    rng = np.random.default_rng(seed)
    X = np.zeros((lanes, n_pad, p), np.float32)
    for b in range(lanes):
        y = rng.integers(0, types, n_real)
        cents = rng.normal(size=(types, p)) * 3.0
        X[b, :n_real] = cents[y] + rng.normal(size=(n_real, p))
    mask = np.arange(n_pad) < n_real
    return pearson_distance(jnp.asarray(X), jnp.asarray(mask)), mask


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-fold", action="store_true")
    ap.add_argument("--breakdown-only", action="store_true",
                    help="only the traced per-scope breakdown of the fold "
                    "program under the production routing")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sharp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    emit(device_kind=dev.device_kind, count=len(jax.devices()), smi=smi)
    if args.breakdown_only:
        fold_breakdown(args)
        return

    from sharp_tpu.ops.cutree_pallas import NUM_WARPS, cutree_multi_pallas
    from sharp_tpu.ops.linkage import (
        cutree_multi,
        ward_linkage_deferred,
        ward_linkage_rnn,
    )

    # --- 1 + 2a: cut replay at the fold shape -----------------------------
    D, mask = clustered_distances(2048, 2000, 80, seed=0)
    links = jax.jit(jax.vmap(ward_linkage_rnn))(D)
    mk = jnp.asarray(mask)
    nr = jnp.asarray(2000)
    mx = jnp.asarray(40)

    def cut_xla(m):
        return jax.vmap(lambda g: cutree_multi(
            g, nr, mk, mx, minN=2, ncand=39, nc_pad=48))(m)

    def cut_kernel(m, num_warps):
        return jax.vmap(lambda g: cutree_multi_pallas(
            g, nr, mk, mx, minN=2, ncand=39, nc_pad=48,
            num_warps=num_warps))(m)

    cx = jax.jit(cut_xla)
    ref = cx(links.merges)
    for num_warps in (1, 2, 4, 8):
        ck = jax.jit(lambda m, w=num_warps: cut_kernel(m, w))
        got = ck(links.merges)
        equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(ref, got))
        first, t = timed(ck, links.merges)
        emit(part="cut_replay", impl="kernel", num_warps=num_warps,
             default=num_warps == NUM_WARPS, n_pad=2048, lanes=80,
             bit_equal=equal, first_s=first, s=t)
    first, t = timed(cx, links.merges)
    emit(part="cut_replay", impl="xla", n_pad=2048, lanes=80,
         first_s=first, s=t)

    # --- 2b: Ward backends alone ------------------------------------------
    backends = {
        "xla": jax.jit(jax.vmap(ward_linkage_deferred)),
        "rnn": jax.jit(jax.vmap(ward_linkage_rnn)),
        "rnn_bf16": jax.jit(jax.vmap(
            lambda d: ward_linkage_rnn(d, store_dtype=jnp.bfloat16))),
    }
    for n_pad, lanes in ((2048, 80), (1024, 16), (512, 16), (256, 16)):
        if n_pad != 2048:
            D, mask = clustered_distances(n_pad, n_pad - n_pad // 16, lanes,
                                          seed=n_pad)
        for name, f in backends.items():
            first, t = timed(f, D, reps=1 if name == "xla" else 2)
            emit(part="ward", backend=name, n_pad=n_pad, lanes=lanes,
                 first_s=first, s=t)
        del D

    if args.skip_fold:
        return
    fold_variants(args)


def fold_inputs(G=16, B=2048, genes=27998, types=12, K=5, p=256):
    """A 16-fold group of planted expression, generated on the device,
    and the fold program's static arguments at the production shape."""
    import jax
    import jax.numpy as jnp

    from sharp_tpu.config import resolve_config
    from sharp_tpu.core.fold import fold_static_args
    from sharp_tpu.ops.rp import ensemble_rp_matrix

    cfg = resolve_config(65536, genes, ensize_K=K, reduced_ndim=p,
                         partition_ncells=2000, rN_seed=7,
                         dtype_compute="bfloat16", forview=False)
    R_all = ensemble_rp_matrix(jax.random.PRNGKey(7), K, genes, p,
                               dtype=jnp.bfloat16)

    @jax.jit
    def gen(key):
        kb, kde, ks, ky, kn, kd = jax.random.split(key, 6)
        base = jnp.exp(1.0 + jax.random.normal(kb, (genes,)))
        de = jax.random.uniform(kde, (genes,)) < 0.35
        signs = jax.random.choice(ks, jnp.asarray([-1.0, 1.0]),
                                  shape=(types, genes))
        tm = base[None] * jnp.where(de[None], 2.0 ** (signs * 6.0), 1.0)
        y = jax.random.randint(ky, (G, B), 0, types)
        X = tm[y] * jnp.exp(0.3 * jax.random.normal(kn, (G, B, genes)))
        X = X * (jax.random.uniform(kd, (G, B, genes)) > 0.2)
        return X / jnp.sum(X, axis=-1, keepdims=True) * 1e6

    Xg = jax.block_until_ready(gen(jax.random.PRNGKey(1)))
    sizes = jnp.full((G,), min(2000, B), jnp.int32)
    masks = jnp.arange(B)[None, :] < sizes[:, None]
    return (Xg, masks, sizes), R_all, fold_static_args(cfg)


def fold_fn(R_all, static):
    import jax
    import jax.numpy as jnp

    from sharp_tpu.core.fold import fold_program

    def run(X, m, s):
        return jax.vmap(lambda x, mm, nn: fold_program(
            x, mm, nn, R_all, jnp.asarray(True), None, has_indN=False,
            **static))(X, m, s)

    return jax.jit(run)


def fold_variants(args):
    """The fold program under each Ward backend and cut replay. The XLA
    cut replay is measured by handing `opt_hclust` XLA's `cutree_multi`
    in place of the kernel for that variant alone."""
    from unittest import mock

    import jax

    from sharp_tpu.analysis.ari import ari
    from sharp_tpu.ops import cutree_pallas
    from sharp_tpu.ops.linkage import cutree_multi

    inputs, R_all, static = fold_inputs()
    variants = [  # (label, linkage_backend, cut replay in the kernel)
        ("auto: rnn / cut kernel", "auto", True),
        ("rnn / cut xla", "rnn", False),
        ("rnn_bf16 / cut kernel", "rnn_bf16", True),
        ("xla serial loop / cut kernel", "xla", True),
    ]
    base = None
    for label, backend, kernel in variants:
        cut = (cutree_pallas.cutree_multi_pallas if kernel else
               lambda *a, num_warps=None, **kw: cutree_multi(*a, **kw))
        with mock.patch.object(cutree_pallas, "cutree_multi_pallas", cut):
            jax.clear_caches()
            f = fold_fn(R_all, dict(static, linkage_backend=backend))
            first, t = timed(f, *inputs, reps=1 if backend == "xla" else 3)
            out = f(*inputs)
        labels = np.asarray(out.finalC)
        base = labels if base is None else base
        n = int(np.asarray(inputs[2])[0])
        fold_ari = [ari(a[:n], b[:n]) for a, b in zip(base, labels)]
        emit(part="fold_program", variant=label, folds=16, B=2048,
             genes=27998, K=5, p=256, compile_and_first_s=first, s=t,
             n_meta=np.asarray(out.n_meta).tolist(),
             fold_label_ari_vs_auto_min=float(min(fold_ari)),
             fold_label_ari_vs_auto_mean=float(np.mean(fold_ari)))


# name-stack fragments, most specific first: a device operation counts
# toward the first scope its HLO op_name contains
SCOPES = ("ward_rnn_tail", "ward_linkage", "cutree_multi", "sweep_scores",
          "wmetac", "pearson_distance", "rp_project")


def scope_times(hlo_text, xspace_path, scopes=SCOPES):
    """(device seconds per name-stack scope, seconds of events that name
    no instruction of the module) from one profiler trace.

    Trace events name the HLO instruction they ran (`hlo_op`); the
    compiled module's text maps each instruction to its op_name, which
    carries the jax.named_scope / jit name stack."""
    import re

    from jax.profiler import ProfileData

    norm = lambda s: s.replace(".", "_").replace("-", "_")  # noqa: E731
    op_name = {
        norm(m.group(1)): m.group(2)
        for m in re.finditer(
            r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"',
            hlo_text, re.M,
        )
    }
    pd = ProfileData.from_file(xspace_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in pd.planes if p.name == "/host:CPU"]
    out = dict.fromkeys(scopes + ("other",), 0.0)
    unmapped = 0.0
    samples = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                # inside a CUDA graph hlo_op names the command buffer and
                # the event name the kernel (the fusion's own name)
                key = next((k for k in (norm(str(stats.get("hlo_op", ""))),
                                        norm(ev.name)) if k in op_name),
                           None)
                if key is None:
                    unmapped += ev.duration_ns * 1e-9
                    if len(samples) < 12:
                        samples.append((ev.name, {k: str(v)[:120] for k, v
                                                  in stats.items()}))
                    continue
                name = op_name[key]
                hit = next((s for s in scopes if s in name), "other")
                out[hit] += ev.duration_ns * 1e-9
    if samples:
        emit(part="unmapped_trace_events", planes=[p.name for p in planes],
             samples=samples)
    return out, unmapped


def fold_breakdown(args, inputs=None):
    """One traced call of the fold program under the production routing,
    reduced to device seconds per scope."""
    import glob
    import tempfile

    import jax

    if inputs is None:
        inputs, R_all, static = fold_inputs()
    else:
        inputs, R_all, static = inputs
    f = fold_fn(R_all, static)
    first, t = timed(f, *inputs, reps=3)
    hlo = f.lower(*inputs).compile().as_text()
    tdir = tempfile.mkdtemp(prefix="fold_trace_")
    jax.profiler.start_trace(tdir)
    jax.block_until_ready(f(*inputs))
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    secs, unmapped = scope_times(hlo, path)
    total = sum(secs.values())
    emit(part="fold_breakdown", wall_s=t, device_s=total,
         unmapped_device_s=unmapped,
         share={k: v / total for k, v in secs.items()} if total else {},
         device_seconds=secs)


if __name__ == "__main__":
    main()
