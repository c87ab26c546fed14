"""Configuration for the SHARP pipeline.

Knob names and auto-scaling defaults mirror the reference driver's ~18-knob
resolution block (reference: /root/reference/R/SHARP.R:119-228), but live in
one dataclass so every result can echo its fully-resolved configuration
(the reference's `paras` convention, R/SHARP.R:292-313).

All *static* quantities that shape compiled programs (padded block size,
candidate-k sweep bounds, cluster-budget paddings) are resolved here, on the
host, before any tracing — XLA sees only static shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(n: int, minimum: int = 8) -> int:
    """Round n up to a padded size from a short ladder of shapes.

    Uses power-of-two buckets up to 512 then multiples of 512: bounds the
    number of distinct compiled shapes while keeping padding waste < 25%.
    """
    n = max(n, minimum)
    if n <= 512:
        return 1 << (n - 1).bit_length()
    return _ceil_to(n, 512)


@dataclasses.dataclass(frozen=True)
class SharpConfig:
    """Resolved SHARP configuration.

    Defaults follow /root/reference/R/SHARP.R:119-228 exactly; see
    `resolve_config` for the auto-scaling rules.
    """

    # --- data ---
    n_cells: int = 0
    n_genes: int = 0

    # --- core knobs (reference names in parens) ---
    reduced_ndim: int = 0          # p            (R/SHARP.R:119-122)
    ensize_K: int = 0              # ensize.K     (R/SHARP.R:254-270)
    base_ncells: int = 5000        # base.ncells  (R/SHARP.R:124-127)
    partition_ncells: int = 2000   # partition.ncells (R/SHARP.R:129-132)
    hmethod: str = "ward.D"        # hmethod      (R/SHARP.R:134-137)
    N_cluster: Optional[int] = None        # fixed cluster count (optional)
    indN_cluster: Optional[int] = None     # per-RP fixed count (optional)
    minN_cluster: int = 2          # minN.cluster (R/SHARP.R:139-142)
    maxN_cluster: int = 40         # maxN.cluster (R/SHARP.R:144-147)
    sil_thre: float = 0.35         # sil.thre     (R/SHARP.R:149-152)
    height_Ntimes: float = 2.0     # height.Ntimes (R/SHARP.R:154-157)
    prep: bool = False             # negative clamp + all-zero-gene drop (R/SHARP.R:74-80,99-106)
    # logflag semantics mirror R/SHARP.R:202-228: it controls whether the
    # testlog *check* runs. None => auto (check when n<1e4, else transform
    # unconditionally); True => run the check; False => log-transform without
    # checking. Use `log_transform` to force the final decision directly.
    logflag: Optional[bool] = None
    log_transform: Optional[bool] = None   # explicit final decision override
    exp_type: Optional[str] = None  # "count"|"CPM"|"TPM"|"FPKM"|... (R/SHARP.R:110-117)
    rN_seed: Optional[int] = None   # None => nonreproducible sentinel (R/SHARP.R:169-179)
    sncells: int = 100             # testlog probe size (R/SHARP.R:879-882)
    forview: bool = True           # keep viE/x0 for visualization (R/SHARP.R:445-449)

    # --- accelerator knobs (no reference equivalent) ---
    n_devices: int = 1             # replaces n.cores (R/SHARP.R:162-167)
    ensemble_axis: int = 1         # mesh partitioning of the K ensemble axis
    dtype_compute: str = "float32"  # matmul input dtype ("bfloat16" on real runs)
    # "auto" | "xla" | "rnn" | "rnn_bf16": auto resolves per padded
    # problem size (ops/linkage.py:resolve_linkage_backend) — the
    # measured per-pad table on the GPU, the serial XLA loop on the CPU
    # and for non-ward hmethods
    linkage_backend: str = "auto"
    block_pad: int = 0             # static padded block size (cells per block)
    nc_pad: int = 64               # padded per-block cluster one-hot width (>= maxN+1)
    meta_nc_budget: int = 2048     # compaction budget for sMetaC global clusters

    @property
    def is_small(self) -> bool:
        return self.n_cells < self.base_ncells

    def replace(self, **kw) -> "SharpConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_reduced_ndim(n_cells: int) -> int:
    """JL-style reduced dimension: ceil(log2(n) / eps^2), eps=0.2.

    Reference: /root/reference/R/SHARP.R:119-122 (`ceiling(log2(ncells)/0.2^2)`).
    """
    return int(math.ceil(math.log2(max(n_cells, 2)) / 0.04))


def resolve_config(
    n_cells: int,
    n_genes: int,
    **overrides,
) -> SharpConfig:
    """Resolve all defaulted knobs from the data dimensions.

    Mirrors the reference's resolution order (R/SHARP.R:119-280):
      - reduced.ndim = ceil(log2(n)/0.04)                 (:121)
      - ensize.K     = 15 if small path else 5            (:256,270)
      - maxN.cluster = max(40, ceil(n/5000))              (:145)
      - prep/logflag auto-disabled at n >= 1e4            (:74-80,202-209)
    """
    cfg = SharpConfig(n_cells=n_cells, n_genes=n_genes)
    kw = dict(overrides)

    # reference knobs that are meaningless on this backend, accepted for
    # signature parity: n.cores sized the fork pool (R/SHARP.R:162-167)
    # — parallelism here is the device mesh (`n_devices`) — and
    # flashmark switched hclust implementations (R/get_opt_hclust.R:76-83)
    # — backend selection here is `linkage_backend`.
    kw.pop("n_cores", None)
    kw.pop("flashmark", None)

    if not kw.get("reduced_ndim"):
        kw["reduced_ndim"] = default_reduced_ndim(n_cells)
    base_ncells = kw.get("base_ncells", cfg.base_ncells)
    small = n_cells < base_ncells
    if not kw.get("ensize_K"):
        kw["ensize_K"] = 15 if small else 5
    if "maxN_cluster" not in kw:
        kw["maxN_cluster"] = max(40, math.ceil(n_cells / 5000))
    if "prep" not in kw:
        kw["prep"] = n_cells < 1e4
    if kw.get("log_transform") is None and kw.get("logflag") is None:
        # reference runs the testlog check only under 1e4 cells; above that
        # it log-transforms unconditionally (R/SHARP.R:202-228)
        if n_cells >= 1e4:
            kw["log_transform"] = True

    if not kw.get("block_pad"):
        pn = kw.get("partition_ncells", cfg.partition_ncells)
        kw["block_pad"] = pad_dim(min(n_cells, pn if not small else n_cells))
    if "nc_pad" not in kw:
        # one-hot width for per-block cluster ids; +8 slack, 8-aligned
        kw["nc_pad"] = _ceil_to(min(kw["maxN_cluster"], 40) + 2, 8)

    return cfg.replace(**kw)
