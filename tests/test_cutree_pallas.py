"""Pallas-Triton cut-replay kernel parity (interpret mode on the CPU).

On the GPU the same kernel compiles through Triton; the GPU lane
(tests/test_gpu_device.py) and chip_smoke.py compare it there at the
production shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sharp_tpu.ops.cutree_pallas import cutree_multi_pallas, replay_snapshots
from sharp_tpu.ops.distance import pearson_distance, standardize_rows
from sharp_tpu.ops.linkage import cutree_multi, ward_linkage, ward_linkage_rnn


def _problem(n, nreal, p, seed):
    rng = np.random.default_rng(seed)
    X = np.zeros((n, p), np.float32)
    X[:nreal] = rng.normal(size=(nreal, p))
    mask = jnp.asarray(np.arange(n) < nreal)
    return pearson_distance(standardize_rows(jnp.asarray(X), mask), mask)


def _assert_same(c1, c2):
    np.testing.assert_array_equal(np.asarray(c1.labels), np.asarray(c2.labels))
    np.testing.assert_array_equal(np.asarray(c1.k), np.asarray(c2.k))
    np.testing.assert_array_equal(np.asarray(c1.valid), np.asarray(c2.valid))


# (96, 90) and (1536, 1500): pads that are not powers of two (pad_dim's
# multiples of 512 above 512), so the kernel's label axis is padded
@pytest.mark.parametrize(
    "n,nreal,ncand", [(64, 50, 13), (128, 128, 13), (96, 90, 39),
                      (1536, 1500, 39)],
)
def test_kernel_matches_xla(n, nreal, ncand):
    D = _problem(n, nreal, 24, seed=3)
    link = ward_linkage_rnn(D)  # any valid merge sequence; the ladder is fast
    mask = jnp.asarray(np.arange(n) < nreal)
    nr = jnp.asarray(nreal)
    maxN = jnp.asarray(40)
    kw = dict(minN=2, ncand=ncand, nc_pad=48)
    _assert_same(
        cutree_multi(link.merges, nr, mask, maxN, **kw),
        cutree_multi_pallas(link.merges, nr, mask, maxN, interpret=True,
                            **kw),
    )


def test_kernel_batched():
    """vmap over members with an unbatched n_real adds a grid axis."""
    K, n = 3, 96
    rng = np.random.default_rng(4)
    Xb = jnp.asarray(rng.normal(size=(K, n, 16)), jnp.float32)
    mask = jnp.ones(n, bool)
    Db = jax.vmap(
        lambda x: pearson_distance(standardize_rows(x, mask), mask)
    )(Xb)
    links = jax.vmap(ward_linkage)(Db)
    nr = jnp.asarray(n)
    maxN = jnp.asarray(20)
    kw = dict(minN=2, ncand=7, nc_pad=16)
    c1 = jax.vmap(lambda mg: cutree_multi(mg, nr, mask, maxN, **kw))(
        links.merges
    )
    c2 = jax.vmap(lambda mg: cutree_multi_pallas(
        mg, nr, mask, maxN, interpret=True, **kw))(links.merges)
    _assert_same(c1, c2)


def test_kernel_nested_vmap_batched_n_real():
    """The fold program's convention: vmap over folds (each with its own
    n_real) around vmap over ensemble members."""
    G, K, n = 2, 2, 64
    nreals = np.asarray([60, 47])
    merges = np.stack([
        np.stack([
            np.asarray(ward_linkage(_problem(n, int(nr), 12, seed=10 * g + k))
                       .merges)
            for k in range(K)
        ])
        for g, nr in enumerate(nreals)
    ])
    masks = jnp.asarray(np.arange(n)[None, :] < nreals[:, None])
    maxN = jnp.asarray(30)
    kw = dict(minN=2, ncand=29, nc_pad=32)

    def over(cut, **extra):
        def fold(mg, nr, m):
            return jax.vmap(lambda g: cut(g, nr, m, maxN, **kw, **extra))(mg)
        return jax.jit(jax.vmap(fold))(
            jnp.asarray(merges), jnp.asarray(nreals), masks
        )

    _assert_same(over(cutree_multi), over(cutree_multi_pallas,
                                          interpret=True))


def test_snapshots_unreached_rows_stay_zero():
    """Candidates with k >= n_real are never reached by the replay; their
    rows stay zero exactly as in the XLA loop (and are masked invalid)."""
    n, nreal = 32, 10
    link = ward_linkage(_problem(n, nreal, 8, seed=5))
    snaps = np.asarray(replay_snapshots(
        link.merges, jnp.asarray(nreal), minN=2, ncand=15, interpret=True
    ))
    assert snaps.shape == (15, n)
    # candidate ci holds k = 2 + ci clusters; k <= nreal - 1 is reached
    assert not snaps[nreal - 2:].any()
    assert (snaps[: nreal - 2] != 0).any(axis=1).all()
