"""Field checkpoint / resume convenience.

The reference has no persistence at all (SURVEY.md §5.4 — all state is the
in-memory CosmoBox, reproducibility via np.random.seed).  Here the
equivalents are explicit PRNG keys (already threaded everywhere) plus
simple npz save/load of a box's fields and metadata, so long Monte-Carlo
campaigns can checkpoint and resume.

For SHARDED arrays (>= 1024^3 cubes living slab-distributed over a mesh)
use :func:`save_sharded` / :func:`load_sharded`: orbax writes each shard
from its own device and restores to a target sharding, so a checkpoint
never funnels the cube through one host (the npz helpers gather — fine on
CPU, the scaling killer for a sharded cube).
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

__all__ = ["save_box", "load_box", "save_fields", "load_fields",
           "save_sharded", "load_sharded"]


def save_fields(path: str, **fields):
    """Save named device arrays to an npz file (complex supported)."""
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in fields.items()
                                 if v is not None})


def load_fields(path: str) -> dict:
    """Load an npz of fields back as jax arrays."""
    with np.load(path) as data:
        return {k: jnp.asarray(data[k]) for k in data.files}


def save_sharded(path: str, tree):
    """Checkpoint a pytree of (possibly sharded) jax arrays with orbax.

    Each device writes its own shards; nothing is gathered.  ``path`` must
    be an absolute directory path (orbax requirement); it is overwritten.
    """
    import os

    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), tree, force=True)


def load_sharded(path: str, template):
    """Restore a :func:`save_sharded` checkpoint onto target shardings.

    ``template`` is a pytree matching the saved structure whose leaves are
    ``jax.ShapeDtypeStruct``s carrying the desired ``sharding`` (or real
    arrays, whose specs are reused) — the standard orbax restore contract.
    """
    import os

    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)

    def as_spec(leaf):
        if isinstance(leaf, jax.ShapeDtypeStruct):
            return leaf
        return jax.ShapeDtypeStruct(leaf.shape, leaf.dtype,
                                    sharding=leaf.sharding)

    spec = jax.tree.map(as_spec, template)
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(path, spec)


def save_box(path: str, box):
    """Checkpoint a CosmoBox: grid metadata, cosmology params, and any
    realised fields."""
    meta = {
        "grid": dataclasses.asdict(box.grid),
        "cosmo": dataclasses.asdict(box.cosmo),
        "dtype": str(np.dtype(box.dtype)),
    }
    fields = {}
    for name in ("delta_x", "delta_k", "phi_k"):
        val = getattr(box, name, None)
        if val is not None:
            fields[name] = np.asarray(val)
    if getattr(box, "velocity_k", None) is not None:
        for i, comp in enumerate("xyz"):
            fields[f"velocity_k_{comp}"] = np.asarray(box.velocity_k[i])
    np.savez_compressed(path, __meta__=json.dumps(meta), **fields)


def load_box(path: str):
    """Restore a CosmoBox checkpoint saved by :func:`save_box`."""
    from .box import CosmoBox

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        g = meta["grid"]
        box = CosmoBox(
            cosmo=meta["cosmo"],
            box_scale=(g["Lx"], g["Ly"], g["Lz"]),
            nsamp=g["N"],
            redshift=g["redshift"],
            line_freq=g["line_freq"],
            realise_now=False,
            dtype=jnp.dtype(meta["dtype"]),
        )
        for name in ("delta_x", "delta_k", "phi_k"):
            if name in data.files:
                setattr(box, name, jnp.asarray(data[name]))
        if "velocity_k_x" in data.files:
            box.velocity_k = tuple(
                jnp.asarray(data[f"velocity_k_{c}"]) for c in "xyz"
            )
    return box
