"""Device-mesh helpers.

The scaling model (SURVEY.md §5.7-5.8): a 2-D logical mesh
``('ens', 'space')`` where 'ens' is pure data parallelism over Monte-Carlo
realisations and 'space' shards the leading spatial axis of each N^3 cube
(slab decomposition).  FFTs along the sharded axis become local FFTs +
all-to-all transposes between devices; everything else is local or a psum.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "largest_pow2_divisor"]


def largest_pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two dividing n, at most cap."""
    p = 1
    while n % (p * 2) == 0 and p * 2 <= cap:
        p *= 2
    return p


def make_mesh(n_devices: int | None = None, space: int | None = None,
              grid_n: int | None = None) -> Mesh:
    """Build an ('ens', 'space') mesh over the first ``n_devices`` devices.

    Parameters:
        n_devices: number of devices (default: all).
        space: size of the spatial axis.  Default: the largest power of two
            dividing both ``n_devices`` and ``grid_n`` (so slabs are even).
        grid_n: box resolution, used to bound the spatial axis.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = np.asarray(devices[:n])
    if space is None:
        cap = grid_n if grid_n is not None else n
        space = largest_pow2_divisor(n, cap)
    assert n % space == 0, f"n_devices={n} not divisible by space={space}"
    ens = n // space
    return Mesh(devices.reshape(ens, space), ("ens", "space"))
