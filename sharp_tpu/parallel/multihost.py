"""Multi-host orchestration for the blocked/streaming path.

The reference is single-node (fork pool, R/SHARP.R:167); its scaling story
is block partitioning. Across hosts the same structure holds (SURVEY.md
§5.7-5.8): each host streams a DISJOINT slice of the cell blocks — no
cross-host traffic during the block pass — and the only collective is one
all-gather of O(clusters x p) block summaries (centroids + counts) before
every host runs the identical deterministic global sMetaC. Shared
randomness is regenerated from the common PRNGKey on every host
(utils/prng.py) instead of broadcast, so block results are
host-placement-invariant.

Wire format of a block summary: (centroids (C, p) f32, counts (C,) f32,
block sizes) — padded to a static per-block budget for the all-gather.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize the jax.distributed runtime when configured.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    when arguments are omitted; a no-op single-process setup otherwise.
    Returns (process_index, process_count).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    # NOTE: jax.process_count() would itself initialize the XLA backend
    # and lock out jax.distributed.initialize — probe the distributed
    # state without touching the backend
    if coordinator_address and not jax.distributed.is_initialized():
        num_processes = num_processes or int(
            os.environ.get("JAX_NUM_PROCESSES", "1")
        )
        process_id = process_id if process_id is not None else int(
            os.environ.get("JAX_PROCESS_ID", "0")
        )
        # CPU backends need an explicit collectives implementation for
        # the cross-process allgather
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    if jax.process_count() > 1 and jax.default_backend() != "cpu":
        raise NotImplementedError(
            "multi-process streaming is proven over CPU gloo collectives "
            f"only, not on {jax.default_backend()!r}; on one host drive "
            "several devices from one process with n_devices instead"
        )
    return jax.process_index(), jax.process_count()


def block_slice(
    n_blocks: int, process_index: int, process_count: int
) -> List[int]:
    """Contiguous block assignment: host h streams blocks [lo, hi).

    Contiguous (not strided) so each host's manifest directory stays
    resume-compatible when the host count changes.
    """
    base = n_blocks // process_count
    rem = n_blocks % process_count
    lo = process_index * base + min(process_index, rem)
    hi = lo + base + (1 if process_index < rem else 0)
    return list(range(lo, hi))


def pad_block_summary(
    cents: np.ndarray, counts: np.ndarray, budget: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a block's (C, p) centroids / (C,) counts to a static budget
    so summaries from all hosts stack into one all-gather payload."""
    C, p = cents.shape
    if C > budget:
        raise ValueError(
            f"block produced {C} clusters > summary budget {budget}; "
            "the budget is derived from maxN_cluster (after the "
            "smetac_range widening) — raise maxN_cluster to cover it"
        )
    cp = np.zeros((budget, p), np.float32)
    cp[:C] = cents
    cc = np.zeros((budget,), np.float32)
    cc[:C] = counts
    return cp, cc


def barrier(process_count: Optional[int] = None) -> None:
    """Cross-process sync point (tiny allgather of one float).

    XLA's Gloo CPU backend hard-codes ~30 s rendezvous/op timeouts, so
    processes must reach every collective within ~30 s of each other. Two
    uses: (1) immediately after distributed_init, while processes are
    still in lockstep, so the Gloo context is established before
    compile/compute skew can accumulate; (2) once per streamed block, so
    the end-of-stream summary all-gather is reached with at most one
    block's worth of skew.
    """
    allgather_summaries(np.zeros((1,), np.float32), process_count)


def allgather_summaries(
    local: np.ndarray, process_count: Optional[int] = None
) -> np.ndarray:
    """All-gather per-host stacked summary payloads.

    local: (n_local_blocks, ...) f32. Returns the concatenation over
    hosts, in process order (every host gets the identical array, so the
    deterministic global sMetaC that follows agrees everywhere). Single
    process: identity.
    """
    import jax

    pc = process_count if process_count is not None else jax.process_count()
    if pc == 1:
        return local
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(local))
