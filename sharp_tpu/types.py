"""Result schema for the SHARP pipeline.

Mirrors the reference's result list (`pred_clusters`,
`unique_pred_clusters`, `distr_pred_clusters`, `N.pred_cluster`, `x0`,
`viE`, `paras`, timing — R/SHARP.R:292-317,437-449): a user of the
reference finds the same fields here, with 1-based integer cluster ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SharpResult:
    pred_clusters: np.ndarray          # (n,) int, 1-based consensus labels
    N_pred_cluster: int
    unique_pred_clusters: List[int]
    distr_pred_clusters: Dict[int, int]
    viE: Optional[np.ndarray] = None   # (n, p) ensemble-mean RP features
    x0: Optional[np.ndarray] = None    # (n, C) wMetaC visualization matrix
    paras: Optional[dict] = None       # fully-resolved config echo
    timing: Optional[dict] = None      # per-stage wall clock
    # extra diagnostics (no reference equivalent)
    per_member_k: Optional[np.ndarray] = None
    per_member_maxsil: Optional[np.ndarray] = None
    folds: Optional[np.ndarray] = None  # (n,) fold index per cell (large path)

    def summary(self) -> str:
        lines = [
            f"SHARP result: {len(self.pred_clusters)} cells, "
            f"{self.N_pred_cluster} clusters",
            f"cluster sizes: {self.distr_pred_clusters}",
        ]
        if self.timing:
            lines.append(f"total time: {self.timing.get('total_seconds', 0):.2f}s")
        return "\n".join(lines)


def finalize_labels(
    raw_labels: np.ndarray,
    merge_tiny: bool = False,
    tiny_threshold: int = 10,
) -> np.ndarray:
    """Tiny-cluster merge + first-occurrence relabel to 1..C.

    Reference: merge clusters with <10 cells into the smallest such id when
    ncells>1e4 and N.cluster not fixed (R/SHARP.R:418-427), then relabel by
    first occurrence via `match(y, unique(y))` (R/SHARP.R:428-443).
    """
    y = np.asarray(raw_labels).copy()
    if merge_tiny:
        vals, counts = np.unique(y, return_counts=True)
        tiny = vals[counts < tiny_threshold]
        if len(tiny) > 0:
            y[np.isin(y, tiny)] = tiny.min()
    _, first_idx = np.unique(y, return_index=True)
    order = y[np.sort(first_idx)]
    remap = {v: i + 1 for i, v in enumerate(order)}
    return np.asarray([remap[v] for v in y], dtype=np.int32)
