"""Large-path tests: fold partitioning + per-fold wMetaC + global sMetaC.

Follows the reference's own recipe for exercising the partitioned path on
small inputs — force base.ncells/partition.ncells down
(README.md:147-154: `SHARP(scExp, base.ncells=2000, partition.ncells=1000)`).
"""

import jax
import numpy as np
import pytest
from sklearn.metrics import adjusted_rand_score

from sharp_tpu import sharp
from sharp_tpu.core.large import fold_sizes
from tests.synth import make_tpm_like


def test_fold_sizes_rebalancing():
    # exact partition
    assert fold_sizes(4000, 2000) == [2000, 2000]
    # small remainder is rebalanced across the last two folds
    sizes = fold_sizes(4100, 2000)
    assert sum(sizes) == 4100
    assert len(sizes) == 3
    assert sizes[0] == 2000
    assert abs(sizes[1] - sizes[2]) <= 1
    assert min(sizes) >= 1000
    # single fold
    assert fold_sizes(1500, 2000) == [1500]


def test_large_path_ari():
    X, y = make_tpm_like(n_cells=1200, n_genes=1500, n_types=6, seed=21)
    res = sharp(
        X,
        rN_seed=7,
        base_ncells=500,        # force the large path
        partition_ncells=300,   # -> 4 folds
        ensize_K=5,
        exp_type="TPM",
    )
    assert len(res.pred_clusters) == 1200
    ari = adjusted_rand_score(y, res.pred_clusters)
    assert ari >= 0.9, f"large-path ARI {ari:.4f}"
    assert res.folds is not None and res.folds.max() >= 2
    assert res.viE.shape == (1200, res.paras["reduced_ndim"])
    u = np.unique(res.pred_clusters)
    assert np.array_equal(u, np.arange(1, len(u) + 1))


def test_large_path_reproducible():
    X, y = make_tpm_like(n_cells=900, n_genes=800, n_types=4, seed=33)
    kw = dict(rN_seed=11, base_ncells=400, partition_ncells=250, ensize_K=4)
    r1 = sharp(X, **kw)
    r2 = sharp(X, **kw)
    np.testing.assert_array_equal(r1.pred_clusters, r2.pred_clusters)


def _fake_fold_results(rng, T, nclust, nc_pad, p, n_fold):
    """Well-separated synthetic fold summaries (tie-free merges)."""
    frs = []
    for _ in range(T):
        k = int(rng.integers(max(nclust - 2, 2), nclust + 1))
        counts = np.zeros(nc_pad, np.float32)
        counts[:k] = rng.multinomial(n_fold, np.ones(k) / k)
        cents = np.zeros((nc_pad, p), np.float32)
        cents[:k] = rng.normal(size=(k, p)) * 4.0
        frs.append({
            "finalC": rng.integers(0, k, n_fold).astype(np.int32),
            "n_meta": k,
            "cent_sum": cents * counts[:, None],
            "counts": counts,
            "k_per": np.full(3, k, np.int32),
            "maxsil": np.full(3, 0.5, np.float32),
            "overflow": False,
        })
    return frs


def test_fuse_blocks_matches_fuse_folds():
    """The batched vmapped per-block sMetaC fuse must reproduce the
    per-block fuse_folds exactly (same smetac semantics, one compile)."""
    from sharp_tpu.config import resolve_config
    from sharp_tpu.core.large import fuse_blocks, fuse_folds

    rng = np.random.default_rng(5)
    cfg = resolve_config(
        40000, 1000, ensize_K=3, reduced_ndim=32, partition_ncells=500,
        forview=False,
    )
    blocks = [
        _fake_fold_results(rng, T=4, nclust=6, nc_pad=cfg.nc_pad, p=32,
                           n_fold=500)
        for _ in range(5)
    ]
    # jitter one block's cluster count so shapes still bucket together
    singles = [fuse_folds(frs, cfg) for frs in blocks]
    batched = fuse_blocks(blocks, cfg, group=3)
    for s, b in zip(singles, batched):
        np.testing.assert_array_equal(s.labels, b.labels)
        assert s.n_final == b.n_final
        np.testing.assert_allclose(s.cents, b.cents, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s.counts, b.counts)


def test_fuse_static_shapes_stable_across_blocks():
    """Blocks with jittered cluster counts in the same NC_pad bucket must
    resolve identical static smetac shapes (no per-block recompiles —
    the round-2 bench regression)."""
    from sharp_tpu.config import resolve_config
    from sharp_tpu.core.large import _prepare_block

    rng = np.random.default_rng(9)
    cfg = resolve_config(
        1306127, 27998, ensize_K=5, reduced_ndim=64, partition_ncells=2000,
        forview=False,
    )
    shapes = set()
    for _ in range(4):
        frs = _fake_fold_results(
            rng, T=25, nclust=40, nc_pad=cfg.nc_pad, p=64, n_fold=2000
        )
        pr = _prepare_block(frs, cfg)
        assert pr.NC_pad == 1024
        shapes.add((pr.NC_pad, pr.minN, pr.ncand, pr.meta_nc_pad))
    assert len(shapes) == 1, f"static fuse shapes vary: {shapes}"


def test_smetac_second_best_override_masks_invalid_candidates():
    """The 2-cluster second-best-silhouette override (R/sMetaC.R:139-147)
    must rank only VALID candidates: an out-of-range cut whose degenerate
    msil would rank second must never win (round-2 fix, core/smetac.py).

    Centroid-Pearson similarity can't organically produce an invalid slot
    outranking the valid runner-up (invalid cuts score exactly 0 and
    dendrogram cuts keep nonnegative medians), so the sweep result is
    injected directly: msil [0.9, 0.2, 0.1, 0.8, 0.0] with slots 3-4
    invalid. Fixed code picks candidate 1 (0.2, the best valid runner-up);
    the pre-fix code picked the invalid 0.8 at slot 3.
    """
    import jax.numpy as jnp

    import sharp_tpu.core.smetac as sm
    from sharp_tpu.ops.select import OptHclust

    ncand, meta_nc_pad, NC_pad = 5, 24, 8

    def fake_opt_hclust(*a, **kw):
        all_labels = jnp.tile(
            jnp.arange(ncand, dtype=jnp.int32)[:, None], (1, NC_pad)
        )
        return OptHclust(
            labels=all_labels[0],
            k=jnp.asarray(2, jnp.int32),
            maxsil=jnp.asarray(0.9, jnp.float32),
            msil=jnp.asarray([0.9, 0.2, 0.1, 0.8, 0.0], jnp.float32),
            ch=jnp.zeros(ncand, jnp.float32),
            oind=jnp.asarray(0, jnp.int32),
            heights=jnp.zeros(NC_pad - 1, jnp.float32),
            all_labels=all_labels,
            valid=jnp.asarray([True, True, True, False, False]),
        )

    real = sm.opt_hclust
    sm.opt_hclust = fake_opt_hclust
    try:
        res = sm.smetac(
            jnp.asarray(np.random.default_rng(0).normal(
                size=(NC_pad, 16)).astype(np.float32)),
            jnp.ones(NC_pad, bool),
            jnp.asarray(NC_pad), jnp.asarray(4),
            # minN=3 keeps this static signature unique so the fake trace
            # can't be reused by (or taken from) any other test's cache
            minN=3, ncand=ncand, meta_nc_pad=meta_nc_pad, sil_thre=0.35,
        )
    finally:
        sm.opt_hclust = real
    assert int(res.oind) == 1, (
        f"override picked candidate {int(res.oind)} — an invalid slot's "
        f"msil outranked the valid runner-up"
    )


def test_fold_program_rnn_backend_matches_xla():
    """The rnn linkage backend (pure XLA, the GPU route for the fold and
    meta pads) produces the same fold summary as the xla loop."""
    import jax.numpy as jnp

    from sharp_tpu.config import resolve_config
    from sharp_tpu.core.fold import fold_program, fold_static_args
    from sharp_tpu.ops.rp import ensemble_rp_matrix
    from synth import make_tpm_like

    X, y = make_tpm_like(n_cells=200, n_genes=300, n_types=4, seed=11)
    cfg = resolve_config(200, 300, ensize_K=3, reduced_ndim=32,
                         partition_ncells=256, rN_seed=3)
    static = fold_static_args(cfg)
    Xp = jnp.zeros((256, 300), jnp.float32).at[:200].set(X)
    mask = jnp.arange(256) < 200
    R = ensemble_rp_matrix(jax.random.PRNGKey(3), 3, 300, 32)

    outs = {}
    for backend in ("xla", "rnn"):
        st = dict(static, linkage_backend=backend)
        s = fold_program(Xp, mask, jnp.asarray(200), R, jnp.asarray(True),
                         None, has_indN=False, **st)
        outs[backend] = np.asarray(s.finalC)
    np.testing.assert_array_equal(outs["xla"], outs["rnn"])

