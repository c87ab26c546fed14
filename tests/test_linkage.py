"""Ward linkage + multi-cut parity vs scipy (sharp_tpu/ops/linkage.py).

R's hclust(method="ward.D") applies Lance-Williams directly to the input
distances; scipy's `linkage(..., 'ward')` is the ward.D2 variant working on
unsquared distances. ward.D on d produces the same merge order as scipy
ward on sqrt(d), with heights h_ward.D = h_scipy^2 — that equivalence is
the parity oracle here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.cluster.hierarchy import fcluster, linkage as scipy_linkage
from scipy.spatial.distance import squareform
from sklearn.metrics import adjusted_rand_score

from sharp_tpu.ops.distance import pearson_distance, standardize_rows
from sharp_tpu.ops.linkage import ward_linkage, cutree_multi


def _random_problem(n, p, seed, npad=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    npad = npad or n
    Xp = np.zeros((npad, p), np.float32)
    Xp[:n] = X
    mask = np.zeros(npad, bool)
    mask[:n] = True
    return X, jnp.asarray(Xp), jnp.asarray(mask)


def _problem(n, nreal, p, seed):
    rng = np.random.default_rng(seed)
    X = np.zeros((n, p), np.float32)
    X[:nreal] = rng.normal(size=(nreal, p))
    mask = jnp.asarray(np.arange(n) < nreal)
    return pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)


def _corr_dist(X):
    C = np.corrcoef(X)
    return 1.0 - C


def test_merge_heights_match_scipy():
    n, p = 60, 24
    X, Xp, mask = _random_problem(n, p, 0)
    D = pearson_distance(standardize_rows(jnp.asarray(X), None), jnp.asarray(mask[:n]))
    res = ward_linkage(D)
    heights = np.asarray(res.heights)[: n - 1]

    d = _corr_dist(X)
    np.fill_diagonal(d, 0.0)
    Z = scipy_linkage(squareform(np.sqrt(np.maximum(d, 0)), checks=False), "ward")
    np.testing.assert_allclose(
        np.sort(heights), np.sort(Z[:, 2] ** 2), rtol=5e-3, atol=1e-3
    )


@pytest.mark.parametrize("npad", [64, 96])
def test_cutree_matches_scipy_fcluster(npad):
    """Exact merge-order + all-cut parity vs scipy, in float64.

    (In float32 near-tie merge orders can legitimately flip vs scipy's
    float64 — the f32 path is covered by the blob/ARI tests instead.)
    """
    n, p = 57, 16
    X, _, _ = _random_problem(n, p, 1)
    d = _corr_dist(X.astype(np.float64))
    np.fill_diagonal(d, 0.0)

    minN, ncand, nc_pad = 2, 10, 16
    with jax.enable_x64(True):
        Dp = np.full((npad, npad), 0.0)
        Dp[:n, :n] = d
        mask = np.zeros(npad, bool)
        mask[:n] = True
        from sharp_tpu.ops.distance import PAD_PAD_DIST, PAD_REAL_DIST

        mi, mj = mask[:, None], mask[None, :]
        Dp = np.where(mi & mj, Dp, np.where(~mi & ~mj, PAD_PAD_DIST, PAD_REAL_DIST))
        np.fill_diagonal(Dp, 0.0)
        res = ward_linkage(jnp.asarray(Dp))
        cuts = cutree_multi(
            res.merges, jnp.asarray(n), jnp.asarray(mask), jnp.asarray(40),
            minN=minN, ncand=ncand, nc_pad=nc_pad,
        )
        labels = np.asarray(cuts.labels)
        ks = np.asarray(cuts.k)

    Z = scipy_linkage(squareform(np.sqrt(np.maximum(d, 0)), checks=False), "ward")
    for ci in range(ncand):
        k = minN + ci
        ref = fcluster(Z, t=k, criterion="maxclust")
        mine = labels[ci][:n]
        assert ks[ci] == k, f"k mismatch at candidate {ci}: {ks[ci]} != {k}"
        assert adjusted_rand_score(ref, mine) == pytest.approx(1.0), f"cut k={k}"
        # padded cells routed to the garbage slot
        assert np.all(labels[ci][n:] == nc_pad - 1)


def test_padding_invariance():
    """Same data, different pad sizes -> identical real-cell labels."""
    n, p = 41, 12
    X, Xp1, mask1 = _random_problem(n, p, 2, npad=48)
    _, Xp2, mask2 = _random_problem(n, p, 2, npad=80)

    def run(Xp, mask):
        D = pearson_distance(standardize_rows(Xp, mask), mask)
        res = ward_linkage(D)
        cuts = cutree_multi(
            res.merges, jnp.asarray(n), mask, jnp.asarray(40),
            minN=2, ncand=6, nc_pad=16,
        )
        return np.asarray(cuts.labels)[:, :n]

    l1 = run(Xp1, mask1)
    l2 = run(Xp2, mask2)
    for ci in range(l1.shape[0]):
        assert adjusted_rand_score(l1[ci], l2[ci]) == pytest.approx(1.0)


@pytest.mark.parametrize("impl", ["fast", "deferred"])
def test_fast_linkage_equals_reference_impl(impl):
    """Lazy row-min cached / deferred-column linkage must reproduce the
    full-argmin loop exactly (same merges, heights), padded and batched."""
    from sharp_tpu.ops.linkage import ward_linkage_deferred, ward_linkage_fast

    if impl == "fast":
        ward_linkage_fast = ward_linkage_fast
    else:
        import functools

        ward_linkage_fast = functools.partial(ward_linkage_deferred, flush=32)

    rng = np.random.default_rng(7)
    for n, nreal in [(64, 50), (128, 128)]:
        X = np.zeros((n, 24), np.float32)
        X[:nreal] = rng.normal(size=(nreal, 24))
        mask = jnp.asarray(np.arange(n) < nreal)
        D = pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)
        r1 = ward_linkage(D)
        r2 = ward_linkage_fast(D)
        np.testing.assert_array_equal(
            np.asarray(r1.merges)[: nreal - 1], np.asarray(r2.merges)[: nreal - 1]
        )
        np.testing.assert_allclose(
            np.asarray(r1.heights)[: nreal - 1],
            np.asarray(r2.heights)[: nreal - 1],
            rtol=1e-6,
        )
    # batched (the ensemble axis)
    K, n = 4, 96
    Xb = jnp.asarray(rng.normal(size=(K, n, 16)), jnp.float32)
    mask = jnp.ones(n, bool)
    Db = jax.vmap(lambda x: pearson_distance(standardize_rows(x, mask), mask))(Xb)
    rb1 = jax.vmap(ward_linkage)(Db)
    rb2 = jax.vmap(ward_linkage_fast)(Db)
    np.testing.assert_array_equal(np.asarray(rb1.merges), np.asarray(rb2.merges))


@pytest.mark.parametrize(
    "rmethod,scipymethod",
    [
        ("single", "single"),
        ("complete", "complete"),
        ("average", "average"),
        ("mcquitty", "weighted"),
        ("ward.D2", "ward"),
        ("median", "median"),
        ("centroid", "centroid"),
    ],
)
def test_general_hmethods_match_scipy(rmethod, scipymethod):
    """Every reference hmethod (R/get_opt_hclust.R:77) against scipy.

    R hclust applies these directly to the dissimilarities, exactly like
    scipy's linkage on a condensed distance; ward.D2 == scipy 'ward'.
    Run in float64 to pin merge order.
    """
    from sharp_tpu.ops.select import _general_linkage
    from sharp_tpu.ops.linkage import cutree_multi

    n = 45
    rng = np.random.default_rng(4)
    X = rng.normal(size=(n, 12))
    d = _corr_dist(X)
    np.fill_diagonal(d, 0.0)
    # R applies median/centroid's recurrence to the RAW dissimilarities;
    # scipy's variants assume the input is Euclidean and square it
    # internally — so R-on-d == scipy-on-sqrt(d) with squared heights
    # (same equivalence as ward.D vs scipy ward).
    sqrt_mode = scipymethod in ("median", "centroid")
    dcond = squareform(np.sqrt(d) if sqrt_mode else d, checks=False)
    Z = scipy_linkage(dcond, scipymethod)
    ref_heights = Z[:, 2] ** 2 if sqrt_mode else Z[:, 2]

    with jax.enable_x64(True):
        from sharp_tpu.ops.distance import similarity_to_distance

        mask = jnp.ones(n, bool)
        Dp = similarity_to_distance(jnp.asarray(1.0 - d), mask)
        link = _general_linkage(Dp, rmethod)
        cuts = cutree_multi(
            link.merges, jnp.asarray(n), mask, jnp.asarray(40),
            minN=2, ncand=6, nc_pad=16,
        )
        labels = np.asarray(cuts.labels)
        heights = np.asarray(link.heights)[: n - 1]

    np.testing.assert_allclose(
        np.sort(heights), np.sort(ref_heights), rtol=1e-8, atol=1e-10
    )
    if not sqrt_mode:
        # label comparison only for monotone methods: with median/centroid
        # inversions, scipy's threshold-based fcluster diverges from R's
        # merge-order cutree (which our replay matches)
        for ci, k in enumerate(range(2, 8)):
            ref = fcluster(Z, t=k, criterion="maxclust")
            assert adjusted_rand_score(ref, labels[ci][:n]) == pytest.approx(
                1.0
            ), f"{rmethod} cut k={k}"


def test_heights_monotone():
    n, p = 50, 10
    X, Xp, mask = _random_problem(n, p, 3, npad=64)
    D = pearson_distance(standardize_rows(Xp, mask), mask)
    res = ward_linkage(D)
    h = np.asarray(res.heights)[: n - 1]
    assert np.all(np.diff(h) >= -1e-5)


class TestRNNLinkage:
    """Reciprocal-NN rounds (ward_linkage_rnn) vs the serial reference."""

    @pytest.mark.parametrize("n,nreal,seed", [(64, 50, 0), (128, 128, 1),
                                              (256, 230, 2)])
    def test_f32_matches_reference(self, n, nreal, seed):
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        rng = np.random.default_rng(seed)
        X = np.zeros((n, 24), np.float32)
        X[:nreal] = rng.normal(size=(nreal, 24))
        mask = jnp.asarray(np.arange(n) < nreal)
        D = pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)
        r1 = ward_linkage(D)
        r2 = ward_linkage_rnn(D)
        np.testing.assert_array_equal(
            np.asarray(r1.merges)[: nreal - 1],
            np.asarray(r2.merges)[: nreal - 1],
        )
        np.testing.assert_allclose(
            np.asarray(r1.heights)[: nreal - 1],
            np.asarray(r2.heights)[: nreal - 1],
            rtol=1e-5,
        )
        # every candidate cut identical
        c1 = cutree_multi(r1.merges, jnp.asarray(nreal), mask,
                          jnp.asarray(40), minN=2, ncand=20, nc_pad=48)
        c2 = cutree_multi(r2.merges, jnp.asarray(nreal), mask,
                          jnp.asarray(40), minN=2, ncand=20, nc_pad=48)
        np.testing.assert_array_equal(
            np.asarray(c1.labels), np.asarray(c2.labels)
        )

    def test_small_pair_cap(self):
        """A cap far below the mutual-pair count still terminates/matches."""
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        n = 128
        rng = np.random.default_rng(5)
        X = jnp.asarray(rng.normal(size=(n, 16)), jnp.float32)
        mask = jnp.ones(n, bool)
        D = pearson_distance(standardize_rows(X, mask), mask)
        r1 = ward_linkage(D)
        r2 = ward_linkage_rnn(D, pair_cap=4)
        np.testing.assert_array_equal(
            np.asarray(r1.merges), np.asarray(r2.merges)
        )

    def test_bf16_storage_quality(self):
        """bf16 storage: same clustering on separated data."""
        from sklearn.metrics import adjusted_rand_score

        from sharp_tpu.ops.linkage import ward_linkage_rnn

        n = 256
        rng = np.random.default_rng(6)
        y = rng.integers(0, 4, n)
        X = (3.0 * np.eye(4)[y] @ rng.normal(size=(4, 16))
             + 0.1 * rng.normal(size=(n, 16))).astype(np.float32)
        mask = jnp.ones(n, bool)
        D = pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)
        r1 = ward_linkage(D)
        r2 = ward_linkage_rnn(D, store_dtype=jnp.bfloat16)
        c1 = cutree_multi(r1.merges, jnp.asarray(n), mask, jnp.asarray(40),
                          minN=4, ncand=1, nc_pad=16)
        c2 = cutree_multi(r2.merges, jnp.asarray(n), mask, jnp.asarray(40),
                          minN=4, ncand=1, nc_pad=16)
        ari = adjusted_rand_score(
            np.asarray(c1.labels)[0], np.asarray(c2.labels)[0]
        )
        assert ari == pytest.approx(1.0)

    def test_vmapped(self):
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        K, n = 3, 96
        rng = np.random.default_rng(7)
        Xb = jnp.asarray(rng.normal(size=(K, n, 16)), jnp.float32)
        mask = jnp.ones(n, bool)
        Db = jax.vmap(
            lambda x: pearson_distance(standardize_rows(x, mask), mask)
        )(Xb)
        r1 = jax.vmap(ward_linkage)(Db)
        r2 = jax.vmap(lambda d: ward_linkage_rnn(d, pair_cap=16))(Db)
        np.testing.assert_array_equal(
            np.asarray(r1.merges), np.asarray(r2.merges)
        )

    @pytest.mark.parametrize("nreal", [512, 470])
    def test_two_phase_compaction(self, nreal):
        """n > compact_n exercises phase 1 + survivor compaction."""
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        n = 512
        rng = np.random.default_rng(8)
        X = np.zeros((n, 24), np.float32)
        X[:nreal] = rng.normal(size=(nreal, 24))
        mask = jnp.asarray(np.arange(n) < nreal)
        D = pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)
        r1 = ward_linkage(D)
        r2 = ward_linkage_rnn(D, compact_n=128, compact_cap=16)
        np.testing.assert_array_equal(
            np.asarray(r1.merges)[: nreal - 1],
            np.asarray(r2.merges)[: nreal - 1],
        )
        np.testing.assert_allclose(
            np.asarray(r1.heights)[: nreal - 1],
            np.asarray(r2.heights)[: nreal - 1],
            rtol=1e-5,
        )

    @pytest.mark.parametrize("n,nreal", [(64, 50), (128, 128), (256, 230)])
    def test_serves_small_pads_bit_equal(self, n, nreal):
        """The ladder serves every pad the serial kernel once took: merges
        bit-equal to the reference loop on tie-free data, every cut
        identical, heights equal up to f32 association order."""
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        D = _problem(n, nreal, 24, seed=0)
        mask = jnp.asarray(np.arange(n) < nreal)
        r1 = ward_linkage(D)
        r2 = ward_linkage_rnn(D)
        np.testing.assert_array_equal(
            np.asarray(r1.merges)[: nreal - 1],
            np.asarray(r2.merges)[: nreal - 1],
        )
        np.testing.assert_allclose(
            np.asarray(r1.heights)[: nreal - 1],
            np.asarray(r2.heights)[: nreal - 1],
            rtol=1e-6,
        )
        c1 = cutree_multi(r1.merges, jnp.asarray(nreal), mask,
                          jnp.asarray(40), minN=2, ncand=39, nc_pad=48)
        c2 = cutree_multi(r2.merges, jnp.asarray(nreal), mask,
                          jnp.asarray(40), minN=2, ncand=39, nc_pad=48)
        np.testing.assert_array_equal(
            np.asarray(c1.labels), np.asarray(c2.labels)
        )

    def test_serves_small_pads_batched(self):
        """The ensemble calling convention (vmap over K members) at the
        default pair cap: bit-equal merges for every member."""
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        K, n = 3, 96
        rng = np.random.default_rng(1)
        Xb = jnp.asarray(rng.normal(size=(K, n, 16)), jnp.float32)
        mask = jnp.ones(n, bool)
        Db = jax.vmap(
            lambda x: pearson_distance(standardize_rows(x, mask), mask)
        )(Xb)
        r1 = jax.vmap(ward_linkage)(Db)
        r2 = jax.vmap(ward_linkage_rnn)(Db)
        np.testing.assert_array_equal(
            np.asarray(r1.merges), np.asarray(r2.merges)
        )

    def test_bf16_storage_small_pad_quality(self):
        """bf16 storage at a meta-problem pad: merge order may flip on
        ties but the planted cut agrees with the f32 reference."""
        from sharp_tpu.ops.linkage import ward_linkage_rnn

        n = 128
        rng = np.random.default_rng(2)
        # well-separated blobs so rounding can't change the k=4 cut
        y = rng.integers(0, 4, n)
        X = (3.0 * np.eye(4)[y] @ rng.normal(size=(4, 16))
             + 0.1 * rng.normal(size=(n, 16))).astype(np.float32)
        mask = jnp.ones(n, bool)
        D = pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)
        r1 = ward_linkage(D)
        r2 = ward_linkage_rnn(D, store_dtype=jnp.bfloat16)
        c1 = cutree_multi(r1.merges, jnp.asarray(n), mask, jnp.asarray(40),
                          minN=4, ncand=1, nc_pad=16)
        c2 = cutree_multi(r2.merges, jnp.asarray(n), mask, jnp.asarray(40),
                          minN=4, ncand=1, nc_pad=16)
        assert adjusted_rand_score(
            np.asarray(c1.labels)[0], np.asarray(c2.labels)[0]
        ) == pytest.approx(1.0)

    def test_exact_ties_duplicates(self):
        """Duplicate points create exact zero-distance ties; the stable
        height sort must stay topological and the clustering correct."""
        from sklearn.metrics import adjusted_rand_score

        from sharp_tpu.ops.linkage import ward_linkage_rnn

        rng = np.random.default_rng(3)
        n = 128
        base = rng.normal(size=(8, 16)).astype(np.float32)
        idx = rng.integers(0, 8, n)
        X = base[idx]
        mask = jnp.ones(n, bool)
        D = pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)
        r2 = ward_linkage_rnn(D, pair_cap=16, compact_n=64, compact_cap=8)
        c2 = cutree_multi(r2.merges, jnp.asarray(n), mask, jnp.asarray(20),
                          minN=8, ncand=1, nc_pad=24)
        assert adjusted_rand_score(
            idx, np.asarray(c2.labels)[0]
        ) == pytest.approx(1.0)

class TestProductionShape:
    """The backends the GPU routing selects at the fold pad (n_pad = 2048
    for ~2000-cell folds) — exercised on CPU so backend drift is caught
    without hardware (a backend test at n_pad = 256 alone once missed a
    regression that only the production pad showed)."""

    @pytest.fixture(scope="class")
    def problem(self):
        from sharp_tpu.ops.linkage import ward_linkage_deferred

        rng = np.random.default_rng(5)
        n_real, npad = 2000, 2048
        types = rng.integers(0, 12, n_real)
        cents = rng.normal(size=(12, 128)) * 3.0
        Xp = np.zeros((npad, 128), np.float32)
        Xp[:n_real] = cents[types] + rng.normal(size=(n_real, 128))
        mask = np.arange(npad) < n_real
        D = pearson_distance(jnp.asarray(Xp), jnp.asarray(mask))
        ref = jax.block_until_ready(ward_linkage_deferred(D))
        return D, ref, types, n_real, npad

    @staticmethod
    def _cuts(merges, n_real, npad, ks):
        lab = np.arange(npad)
        m = np.asarray(merges)
        out = {}
        for t in range(npad - 1):
            lab[lab == m[t, 1]] = m[t, 0]
            if n_real - t - 1 in ks:
                out[n_real - t - 1] = lab[:n_real].copy()
        return out

    def test_rnn_f32_matches_xla_at_2048(self, problem):
        from sharp_tpu.ops.linkage import (
            validate_merge_sequence,
            ward_linkage_rnn,
        )

        D, ref, types, n_real, npad = problem
        res = jax.block_until_ready(ward_linkage_rnn(D))
        assert validate_merge_sequence(
            res.merges, res.heights, n_real, npad
        ) == []
        ref_cuts = self._cuts(ref.merges, n_real, npad, {2, 5, 12, 20})
        cuts = self._cuts(res.merges, n_real, npad, {2, 5, 12, 20})
        for k in (2, 5, 12, 20):
            assert adjusted_rand_score(ref_cuts[k], cuts[k]) == 1.0, k

    def test_rnn_bf16_valid_and_accurate_at_2048(self, problem):
        """bf16 storage rounds near-tie merge orders (exact equality is
        not expected); the sequence must stay structurally valid and the
        planted-structure cut must be exact."""
        from sharp_tpu.ops.linkage import (
            validate_merge_sequence,
            ward_linkage_rnn,
        )

        D, ref, types, n_real, npad = problem
        res = jax.block_until_ready(
            ward_linkage_rnn(D, store_dtype=jnp.bfloat16)
        )
        assert validate_merge_sequence(
            res.merges, res.heights, n_real, npad
        ) == []
        cuts = self._cuts(res.merges, n_real, npad, {12})
        assert adjusted_rand_score(types, cuts[12]) >= 0.999
