"""PRNG key discipline.

The reference pins all stochastic stages from one integer seed `rN.seed`
(RP sampling R/ranM.R:20-24, per-member seeds `50 + rN.seed + k`
R/SHARP.R:360, cell reshuffle seed R/SHARP.R:497). We map that to a single
`jax.random.PRNGKey` with `fold_in` sub-streams, which additionally gives us
*deterministic regeneration* of the shared RP matrices on every host — the
replacement for the reference's copy-on-write broadcast of `rM`
into forked workers (R/SHARP.R:541-554).

Stream layout:
    key                     = PRNGKey(rN_seed)
    member_key(key, k)      = fold_in(key, 1000 + k)     # RP member k
    shuffle_key(key)        = fold_in(key, 1)            # cell permutation
    testlog_key(key)        = fold_in(key, 2)            # log-decision probe
"""

from __future__ import annotations

import secrets
from typing import Optional

import jax


def seed_to_key(rN_seed: Optional[int]) -> jax.Array:
    """Map the reference's rN.seed knob to a PRNGKey.

    `None` reproduces the reference's 0.5 sentinel = "not reproducible"
    (R/SHARP.R:169-179): a fresh random seed per call.
    """
    if rN_seed is None:
        rN_seed = secrets.randbits(31)
    return jax.random.PRNGKey(int(rN_seed))


def member_key(key: jax.Array, k) -> jax.Array:
    """Key for ensemble member k (the reference's `50 + rN.seed + k`, R/SHARP.R:360)."""
    return jax.random.fold_in(jax.random.fold_in(key, 1000), k)


def shuffle_key(key: jax.Array) -> jax.Array:
    return jax.random.fold_in(key, 1)


def testlog_key(key: jax.Array) -> jax.Array:
    return jax.random.fold_in(key, 2)
