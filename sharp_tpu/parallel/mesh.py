"""Device-mesh construction for the SHARP parallel axes.

The framework's two parallel axes replace the reference's fork-pool
(R/SHARP.R:167, `foreach(k) %:% foreach(t) %dopar%`):

  * "data" — cell folds/blocks (the reference's T axis); scales across
    devices/hosts; the central axis (SURVEY.md §2.2).
  * "ens"  — the K-member RP ensemble (the reference's K axis); a second
    mesh dimension when devices outnumber folds.

RP matrices are *regenerated* from the shared PRNGKey on every host
instead of broadcast (sharp_tpu/utils/prng.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_data: Optional[int] = None,
    n_ens: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a ("data", "ens") mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    nd = len(devices)
    if n_data is None:
        n_data = nd // n_ens
    if n_data * n_ens > nd:
        raise ValueError(
            f"mesh {n_data}x{n_ens} needs {n_data * n_ens} devices, have {nd}"
        )
    grid = np.asarray(devices[: n_data * n_ens]).reshape(n_data, n_ens)
    return Mesh(grid, ("data", "ens"))


def resolve_mesh(cfg) -> Optional[Mesh]:
    """Mesh for cfg.n_devices devices, or None for the single-device path.

    Fewer visible devices than requested is an error, not a silent
    single-device run. The "ens" axis is carved out only when
    cfg.ensemble_axis divides both ensize_K and n_devices; a
    requested-but-undividable ensemble_axis is rejected the same way
    instead of silently running ens-replicated.
    """
    if cfg.n_devices <= 1:
        return None
    if len(jax.devices()) < cfg.n_devices:
        raise ValueError(
            f"n_devices={cfg.n_devices} requested but only "
            f"{len(jax.devices())} devices are visible"
        )
    n_ens = 1
    if cfg.ensemble_axis > 1:
        if (
            cfg.ensize_K % cfg.ensemble_axis
            or cfg.n_devices % cfg.ensemble_axis
        ):
            raise ValueError(
                f"ensemble_axis={cfg.ensemble_axis} must divide both "
                f"ensize_K={cfg.ensize_K} and n_devices={cfg.n_devices}"
            )
        n_ens = cfg.ensemble_axis
    return make_mesh(n_data=cfg.n_devices // n_ens, n_ens=n_ens)
