"""Sparse block feed: ship CSR triplets to the device, densify on-chip.

The reference streams dense RDS blocks and R densifies on the host
(R/SHARP_unlimited3.R:103-131). On an accelerator the bottleneck is
host->device bandwidth, not FLOPs (SURVEY.md §7.3 item 6): a 50k x 28k f32 block is
5.6 GB dense but ~0.5-1 GB as CSR triplets at single-cell densities, so
the streaming path ships a compact wire format — per-row COUNTS plus
uint16 column ids (int32 fallback past 65535 genes) plus f32 values,
~6 B/nnz — derives row ids on device from the counts, and scatters into
the padded dense fold with a plain hint-free XLA scatter, with log2(1+x)
fused into the scatter values. NEVER pass `indices_are_sorted=True` /
`unique_indices=True` here: an earlier accelerator's lowering returned
silently wrong values at production shapes (~98% of 4M nnz corrupted at
2000 x 27998) while small shapes round-trip fine — the GPU lane's
regression test_densify_production_shape_exact pins it.

Numerically exact: the scatter places the same f32 values a host densify
would, so sparse-fed and dense-fed runs produce bit-identical labels
(tests/test_streaming.py pins this).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class SparseBlock(NamedTuple):
    """A cells-by-genes CSR block resident on host."""

    n: int
    g: int
    indptr: np.ndarray   # (n + 1,) int64
    indices: np.ndarray  # (nnz,) int32, sorted within each row
    data: np.ndarray     # (nnz,) float32

    @property
    def shape(self):
        return (self.n, self.g)

    def __len__(self):
        return self.n

    @classmethod
    def from_scipy(cls, X) -> "SparseBlock":
        csr = X.tocsr()
        csr.sum_duplicates()
        csr.sort_indices()
        return cls(
            n=csr.shape[0], g=csr.shape[1],
            indptr=csr.indptr.astype(np.int64),
            indices=csr.indices.astype(np.int32),
            data=csr.data.astype(np.float32),
        )

    @classmethod
    def from_sblk(cls, path: str) -> "SparseBlock":
        # copy=False: the parse returns memory-mapped views with the
        # right dtypes already — a same-dtype astype COPY here cost
        # ~7 s/block on first-touch-fault-expensive VMs (io/native.py
        # _py_parse docstring). uint16-valued files (dt=1) still
        # convert, on their much smaller payload.
        from sharp_tpu.io.native import _py_parse

        n, g, nnz, dt, indptr, indices, vals = _py_parse(path)
        # pre-fault the mapped payload NOW (one touch per 4K page):
        # from_sblk runs on the prefetch thread, so the page-cache
        # fault-in overlaps the previous block's device work instead of
        # serializing into the fold loop's slice phase
        for a in (indices, vals):
            if a.size:
                a.reshape(-1)[:: 4096 // a.itemsize].max()
        return cls(
            n=n, g=g, indptr=indptr.astype(np.int64, copy=False),
            indices=indices.astype(np.int32, copy=False),
            data=vals.astype(np.float32, copy=False),
        )

    def densify(self) -> np.ndarray:
        import scipy.sparse as sp

        return np.asarray(
            sp.csr_matrix(
                (self.data, self.indices, self.indptr), shape=self.shape
            ).todense(),
            np.float32,
        )


def nnz_pad(nnz: int, step: int = 1 << 19) -> int:
    """Pad an nnz count to a coarse bucket (bounds compiled shapes)."""
    return max(step, ((nnz + step - 1) // step) * step)


def fold_triplets(
    sb: SparseBlock,
    starts: Sequence[int],
    sizes: Sequence[int],
    block_pad: int,
    budget: int,
    wire_dtype: str = "float32",
):
    """Padded (counts, cols, vals) for a group of folds of one block.

    The wire format is transfer-minimal for the host->device link (often
    the streaming bottleneck on a slow link):
      * counts (G, block_pad) int32 — per-row nonzero counts; row ids are
        DERIVED on device from their cumulative sum (densify_folds), so
        the O(nnz) row vector never crosses the link;
      * cols (G, budget) uint16 when genes fits (int32 otherwise);
      * vals (G, budget) f32 — exact values, bit-equality preserved —
        or bf16 with `wire_dtype="bfloat16"`: 4 bytes/nnz instead of 6,
        values rounded to bf16 on the wire. The LOSSY mode is an
        explicit opt-in for link-bound deployments (the compute path
        already runs bf16; labels measure ARI ~1.0 vs the exact wire on
        the test workloads) — the default keeps sparse-fed == dense-fed
        bit-identity.
    6 bytes/nnz instead of the naive 12 (rows+cols+vals as int32/f32).
    Entries past a fold's nnz are dropped on device (derived row ==
    block_pad, out of bounds for the scatter).
    """
    import ml_dtypes

    G = len(starts)
    cdt = np.uint16 if sb.g <= np.iinfo(np.uint16).max + 1 else np.int32
    vdt = (
        ml_dtypes.bfloat16 if wire_dtype == "bfloat16" else np.float32
    )
    counts = np.zeros((G, block_pad), np.int32)
    cols = np.zeros((G, budget), cdt)
    vals = np.zeros((G, budget), vdt)
    for gi, (r0, sz) in enumerate(zip(starts, sizes)):
        p0 = int(sb.indptr[r0])
        p1 = int(sb.indptr[r0 + sz])
        nnz = p1 - p0
        if nnz > budget:
            raise ValueError(
                f"fold nnz {nnz} exceeds budget {budget}; raise nnz_pad step"
            )
        counts[gi, :sz] = np.diff(sb.indptr[r0 : r0 + sz + 1])
        cols[gi, :nnz] = sb.indices[p0:p1].astype(cdt, copy=False)
        vals[gi, :nnz] = sb.data[p0:p1]
    return counts, cols, vals


@functools.partial(
    jax.jit, static_argnames=("block_pad", "genes", "log2p1")
)
def densify_folds(
    counts, cols, vals, *, block_pad: int, genes: int, log2p1: bool = False
):
    """Scatter grouped CSR data into dense (G, block_pad, genes) f32.

    Row ids are derived ON DEVICE from the per-row `counts` (see
    fold_triplets): rows[i] = #{cumsum(counts) <= i}, computed as the
    prefix sum of row-boundary markers — a block_pad-element scatter-add
    plus one O(nnz) cumsum. NOT a searchsorted: the binary search's
    nnz x log(block_pad) gathers cost many times the densify scatter
    itself. Entries past the
    fold's total nnz derive row == block_pad, out of bounds, and are
    dropped.

    NO sorted/unique scatter hints: with `indices_are_sorted=True` the
    scatter lowering of an earlier accelerator returned deterministically
    WRONG values at production shapes (~4.03M of 4.1M nonzeros corrupted
    per 2000 x 27998 fold — even with genuinely lexicographically-sorted,
    fully unique index tuples — while the small shapes the CPU tests
    cover round-trip fine). The hint-free scatter is verified bit-exact
    at production shape by the GPU lane
    (tests/test_gpu_device.py::test_densify_production_shape_exact).

    `log2p1=True` fuses the fold program's log2(1 + x) transform into the
    scatter: it is applied to the O(nnz) value vector BEFORE densifying
    (zeros map to log2(1 + 0) = 0, so the dense result is elementwise
    identical to densify-then-log2), which deletes one full
    (G, block_pad, genes) HBM copy from the streaming fold pass.
    """
    budget = cols.shape[-1]

    def one(cnt, c, v):
        cum = jnp.cumsum(cnt.astype(jnp.int32))
        # row of entry i = number of row-end markers at positions <= i
        # (a marker sits at each row's END offset; empty rows stack
        # markers at the same position and the prefix sum skips them,
        # exactly searchsorted(cum, i, side="right"))
        marker = (
            jnp.zeros((budget,), jnp.int32).at[cum].add(1, mode="drop")
        )
        r = jnp.cumsum(marker)
        v = v.astype(jnp.float32)  # no-op for the exact f32 wire
        if log2p1:
            v = jnp.log2(1.0 + v)
        X = jnp.zeros((block_pad, genes), jnp.float32)
        return X.at[r, c.astype(jnp.int32)].set(v, mode="drop")

    return jax.vmap(one)(counts, cols, vals)
