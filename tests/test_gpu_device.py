"""On-device lane: production-shape checks on the GPU.

Each test skips without a GPU; `python chip_smoke.py` runs the lane
in-process on the card. A reduced-precision matmul once corrupted every
merge sequence on an accelerator while the CPU tests stayed green — the
class of regression this lane catches. Mirrors the reference's
run-on-real-data acceptance convention (reference README.md:104-116).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_backend():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("no GPU backend available")
    from sharp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    return jax


def _cuts_of(merges, n_real, n_pad, ks):
    """Cluster partition at each k via host replay of the merge sequence."""
    lab = np.arange(n_pad)
    out = {}
    m = np.asarray(merges)
    for t in range(n_pad - 1):
        lab[lab == m[t, 1]] = m[t, 0]
        k_now = n_real - t - 1
        if k_now in ks:
            out[k_now] = lab[:n_real].copy()
    return out


@pytest.mark.parametrize("n_pad,n_real", [(2048, 2000), (1024, 1000)])
def test_linkage_backends_production_shapes(gpu_backend, n_pad, n_real):
    """The ladder in f32 (routed) and bf16 (opt-in) storage must produce
    structurally valid merge sequences on the card at the production
    pads, with cuts matching the exact serial reference on the same
    distance matrix, and the cut-replay kernel must equal XLA's loop bit
    for bit."""
    jax = gpu_backend
    import jax.numpy as jnp

    from sharp_tpu.analysis.ari import ari
    from sharp_tpu.ops.cutree_pallas import cutree_multi_pallas
    from sharp_tpu.ops.distance import pearson_distance
    from sharp_tpu.ops.linkage import (
        cutree_multi,
        validate_merge_sequence,
        ward_linkage,
        ward_linkage_rnn,
    )

    rng = np.random.default_rng(0)
    types = rng.integers(0, 12, n_real)
    cents = rng.normal(size=(12, 256)) * 3.0
    X = np.zeros((n_pad, 256), np.float32)
    X[:n_real] = cents[types] + rng.normal(size=(n_real, 256))
    mask = np.arange(n_pad) < n_real
    # one D for both sides, so upstream rounding cannot flip a near tie
    D = jax.block_until_ready(
        pearson_distance(jnp.asarray(X), jnp.asarray(mask))
    )

    ref = jax.block_until_ready(ward_linkage(D))
    assert not validate_merge_sequence(ref.merges, ref.heights, n_real, n_pad)
    ref_cuts = _cuts_of(ref.merges, n_real, n_pad, {2, 5, 12, 20})

    for tag, st in [("rnn_f32", None), ("rnn_bf16", jnp.bfloat16)]:
        res = jax.block_until_ready(ward_linkage_rnn(D, store_dtype=st))
        errs = validate_merge_sequence(res.merges, res.heights, n_real, n_pad)
        assert not errs, f"{tag}: {errs}"
        cuts = _cuts_of(res.merges, n_real, n_pad, {2, 5, 12, 20})
        for k in (2, 5, 12, 20):
            a = ari(ref_cuts[k], cuts[k])
            if st is jnp.bfloat16 and k > 12:
                # beyond the 12 planted types a cut splits near-duplicate
                # substructure whose margins sit below bf16 store
                # resolution: which split the tree makes is
                # rounding-determined (0.80 measured at k=20; cuts at or
                # above the planted structure are exact). Gate pinned
                # just under that value so a fine-cut regression shows.
                assert a > 0.78, f"{tag} cut k={k} vs reference (ARI {a})"
            else:
                assert a > 0.999, (
                    f"{tag} cut k={k} diverges from the reference (ARI {a})"
                )

    mk = jnp.asarray(mask)
    kw = dict(minN=2, ncand=39, nc_pad=48)
    c1 = cutree_multi(ref.merges, jnp.asarray(n_real), mk, jnp.asarray(40),
                      **kw)
    c2 = cutree_multi_pallas(ref.merges, jnp.asarray(n_real), mk,
                             jnp.asarray(40), **kw)
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mini_end_to_end_sharp(gpu_backend):
    """sharp() large path at n=5000 on the card with an ARI gate."""
    import sys

    sys.path.insert(0, "tests")
    from synth import make_tpm_like

    from sharp_tpu import sharp
    from sharp_tpu.analysis.ari import ari as adjusted_rand_score

    X, y = make_tpm_like(n_cells=5000, n_genes=2000, n_types=8, seed=13)
    res = sharp(
        X, rN_seed=7, ensize_K=5, exp_type="TPM", forview=False,
        dtype_compute="bfloat16",
    )
    ari = adjusted_rand_score(y, res.pred_clusters)
    assert ari >= 0.9, f"on-device end-to-end ARI {ari:.4f}"


def test_sparse_device_feed_bit_identical(gpu_backend, tmp_path):
    """CSR triplet transfer + on-device scatter densify == dense feed,
    on the card (the production streaming input path)."""
    import sys

    sys.path.insert(0, "tests")
    from synth import make_tpm_like

    from sharp_tpu import sharp_unlimited
    from sharp_tpu.io.blocks import save_blocks

    X, y = make_tpm_like(n_cells=1000, n_genes=600, n_types=5, seed=41)
    d = str(tmp_path / "sblk")
    save_blocks(d, [X[:400], X[400:700], X[700:]], fmt="sblk")
    kw = dict(rN_seed=19, ensize_K=4, partition_ncells=250, base_ncells=300,
              dtype_compute="bfloat16", resume=False)
    r_dense = sharp_unlimited(d, sparse_feed=False, **kw)
    r_sparse = sharp_unlimited(d, sparse_feed=True, **kw)
    np.testing.assert_array_equal(r_dense.pred_clusters, r_sparse.pred_clusters)


def test_streaming_hbm_budget_group_sizing(gpu_backend, tmp_path, monkeypatch):
    """Memory-aware fold grouping on the card: a tight
    SHARP_TPU_HBM_BUDGET must shrink the staged group, the run must
    complete, labels must be invariant to the group size, and —
    when the backend reports memory stats — the pass must stay inside a
    small multiple of the budget."""
    import sys

    sys.path.insert(0, "tests")
    from synth import make_tpm_like

    from sharp_tpu import sharp_unlimited
    from sharp_tpu.io.blocks import save_blocks
    from sharp_tpu.parallel.sharded import auto_group

    jax = gpu_backend
    X, y = make_tpm_like(n_cells=4000, n_genes=2000, n_types=6, seed=3)
    d = str(tmp_path / "sblk")
    save_blocks(d, [X[:2000], X[2000:]], fmt="sblk")
    kw = dict(rN_seed=7, ensize_K=4, partition_ncells=500,
              dtype_compute="bfloat16", resume=False)

    r_wide = sharp_unlimited(d, group=8, **kw)

    budget = 48 << 20  # 48 MB: forces a small group at this shape
    monkeypatch.setenv("SHARP_TPU_HBM_BUDGET", str(budget))
    g = auto_group(512, 2000, sparse=True)
    assert g < 8, f"budget did not bind (group={g})"

    dev = jax.local_devices()[0]
    stats0 = dev.memory_stats() or {}
    r_tight = sharp_unlimited(d, **kw)  # group auto-sized from the budget
    np.testing.assert_array_equal(r_wide.pred_clusters, r_tight.pred_clusters)

    stats1 = dev.memory_stats() or {}
    if "bytes_in_use" in stats1 and "bytes_in_use" in stats0:
        # loose envelope: staged groups honor the budget; the fold
        # program's own working set rides on top
        growth = stats1["bytes_in_use"] - stats0["bytes_in_use"]
        assert growth < 8 * budget, f"resident growth {growth / 1e6:.0f} MB"


def test_densify_production_shape_exact(gpu_backend):
    """The sparse device-feed scatter must be bit-exact at PRODUCTION
    shape on the card. Regression pin: with indices_are_sorted=True an
    earlier accelerator's scatter lowering corrupted ~98% of nonzeros at
    2000 x 27998 / ~4M nnz (while the 600-gene small-shape test stayed
    green), silently feeding garbage expression to every fold of the
    streaming path."""
    import scipy.sparse as sp

    from sharp_tpu.io.sparse import (
        SparseBlock, densify_folds, fold_triplets, nnz_pad,
    )

    rng = np.random.default_rng(5)
    n, genes, keep = 2000, 27998, 2048
    cols = np.sort(
        rng.integers(0, genes, (n, keep), dtype=np.int32), axis=1
    )
    # dedup within rows: bump duplicates onto distinct columns
    for i in range(n):
        u, idx = np.unique(cols[i], return_index=True)
        extra = rng.choice(
            np.setdiff1d(np.arange(genes, dtype=np.int32), u,
                         assume_unique=False),
            keep - len(u), replace=False,
        )
        cols[i] = np.sort(np.concatenate([u, extra.astype(np.int32)]))
    vals = rng.lognormal(2.0, 1.0, (n, keep)).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * keep
    sb = SparseBlock(n=n, g=genes, indptr=indptr,
                     indices=cols.ravel(), data=vals.ravel())

    block_pad = 2048
    budget = nnz_pad(n * keep)
    rows_t, cols_t, vals_t = fold_triplets(
        sb, [0], [n], block_pad, budget
    )
    dense = np.asarray(densify_folds(
        rows_t, cols_t, vals_t, block_pad=block_pad, genes=genes
    ))[0]
    ref = np.asarray(sp.csr_matrix(
        (sb.data, sb.indices, sb.indptr), shape=(n, genes)
    ).todense(), np.float32)
    np.testing.assert_array_equal(dense[:n], ref)
    assert not dense[n:].any()

    dlog = np.asarray(densify_folds(
        rows_t, cols_t, vals_t, block_pad=block_pad, genes=genes,
        log2p1=True,
    ))[0]
    import jax.numpy as jnp

    ref_log = np.asarray(jnp.log2(1.0 + jnp.asarray(ref)))
    np.testing.assert_allclose(dlog[:n], ref_log, rtol=0, atol=0)


def test_streaming_forview_on_device(gpu_backend, tmp_path):
    """forview=True through the streaming path on the card: the view
    planes ride the selective bulk readback (summaries_to_host) and the
    embedding runs on the blocked result."""
    import sys

    sys.path.insert(0, "tests")
    from synth import make_tpm_like

    from sharp_tpu import sharp_unlimited
    from sharp_tpu.analysis.embed import visualization_embedding
    from sharp_tpu.io.blocks import save_blocks

    X, y = make_tpm_like(n_cells=1000, n_genes=600, n_types=5, seed=41)
    d = str(tmp_path / "sblk")
    save_blocks(d, [X[:400], X[400:700], X[700:]], fmt="sblk")
    res = sharp_unlimited(
        d, rN_seed=19, ensize_K=4, partition_ncells=250, base_ncells=300,
        dtype_compute="bfloat16", resume=False, forview=True,
    )
    assert res.viE is not None and res.viE.shape[0] == 1000
    assert res.x0 is not None and res.x0.shape == (1000, res.N_pred_cluster)
    emb, idx = visualization_embedding(res, n_iter=50)
    assert emb.shape == (1000, 2) and np.isfinite(emb).all()
