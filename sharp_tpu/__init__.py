"""sharp_tpu — an accelerator-native single-cell clustering engine.

A from-scratch JAX/XLA/Pallas implementation of the SHARP algorithm family
(ensemble sparse random projection -> per-projection hierarchical clustering
with automatic model selection -> weighted meta-clustering (wMetaC) ->
similarity meta-clustering (sMetaC) for partitioned / out-of-core data),
re-designed for an accelerator: static shapes, masked padding, matmuls for
every hot loop, and `jax.sharding` meshes instead of process pools.

Public API mirrors the reference R package's entry points
(reference: /root/reference/R/SHARP.R:44, NAMESPACE:3-26):

    sharp(X, ...)             ~ SHARP()
    sharp_unlimited(...)      ~ SHARP_unlimited / SHARP_unlimited3
    run_mtimes(...)           ~ run_Mtimes_SHARP
    ari(truth, pred)          ~ ARI
    get_marker_genes(...)     ~ get_marker_genes
    visualization_embedding() ~ visualization_SHARP (embedding part)
"""

from sharp_tpu.config import SharpConfig, resolve_config

__version__ = "0.1.0"

# Lazy public-API exports: lets kernel subpackages be used/tested standalone
# without importing the whole pipeline (and keeps import time low).
_LAZY = {
    "sharp": ("sharp_tpu.api", "sharp"),
    "sharp_unlimited": ("sharp_tpu.api", "sharp_unlimited"),
    "run_mtimes": ("sharp_tpu.api", "run_mtimes"),
    "ari": ("sharp_tpu.analysis.ari", "ari"),
    "get_marker_genes": ("sharp_tpu.analysis.markers", "get_marker_genes"),
    "get_marker_genes_unlimited2": (
        "sharp_tpu.analysis.markers", "get_marker_genes_unlimited2"
    ),
    "get_percluster_exp": ("sharp_tpu.analysis.percluster", "get_percluster_exp"),
    "visualization_embedding": ("sharp_tpu.analysis.embed", "visualization_embedding"),
    "get_opt_hclust": ("sharp_tpu.ops.select", "get_opt_hclust"),
    "gethclust": ("sharp_tpu.ops.select", "gethclust"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'sharp_tpu' has no attribute {name!r}")

__all__ = [
    "SharpConfig",
    "resolve_config",
    "sharp",
    "sharp_unlimited",
    "run_mtimes",
    "ari",
    "get_marker_genes",
    "get_marker_genes_unlimited2",
    "get_percluster_exp",
    "visualization_embedding",
    "get_opt_hclust",
    "gethclust",
]
