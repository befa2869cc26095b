"""Checkpoints and config files (counterpart of
``fluidsim_tpu/io/checkpoint.py``).

A checkpoint is the JAX package's ``.npz``: one array each for ``density``,
``velocity``, ``pressure``, ``obstacles``, ``step`` and ``time``, and the
config as JSON bytes under ``config_json``.  A config file is that JSON,
the same text ``fluidsim_tpu.io.checkpoint.config_to_json`` writes.  Files
go both ways between the two packages.

bfloat16 fields: the JAX package writes the arrays that ``np.asarray``
gives it, whose ``ml_dtypes`` bfloat16 dtype ``np.savez`` stores as raw
two-byte records (``|V2``); its own ``load_checkpoint`` then refuses them
(JAX takes no void dtype).  This module reads a ``|V2`` field as the
bfloat16 bit patterns it holds, and writes a bfloat16 field as the float32
array of its values, which both packages load (the JAX package as float32
arrays; this one, under a bfloat16 config, back to bfloat16 exactly).  It
imports no ``ml_dtypes``, which a machine without JAX may lack.

``save_checkpoint_sharded`` and ``load_checkpoint_sharded`` stand where the
JAX package's orbax pair does (``save_checkpoint_orbax``,
``load_checkpoint_orbax``: a snapshot that keeps the sharding and never
gathers the state onto one host), without orbax: a directory of one
``.npy`` a field a slab, written from each shard's device one slab at a
time, and read back onto a mesh of any shard count that divides n, each
shard reading only its planes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from ..config import ColorMode, ObstacleShape, SimConfig, SourceSpec
from ..state import FluidState
from .convert import FIELDS, from_bits, state_from_numpy, state_to_numpy, to_bits


def save_checkpoint(path: str, state: FluidState, cfg: SimConfig) -> None:
    """Write ``state`` and ``cfg`` to ``path`` (.npz)."""
    np.savez_compressed(
        path, **state_to_numpy(state),
        config_json=np.bytes_(config_to_json(cfg).encode()),
    )


def _field_array(a: np.ndarray) -> np.ndarray:
    """A stored field: two-byte records are bfloat16 bit patterns (the JAX
    package's bfloat16 arrays), returned as float32 values."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).float().numpy()
    return a


def load_checkpoint(path: str, device="cuda") -> Tuple[FluidState, SimConfig]:
    """Read a checkpoint back onto ``device``: the fields in the config's
    dtype (a float32 array under a bfloat16 config must hold bfloat16
    values)."""
    with np.load(path, allow_pickle=False) as z:
        cfg = config_from_json(bytes(z["config_json"]).decode())
        arrays = {k: z[k] for k in ("obstacles", "step", "time")}
        arrays.update({k: _field_array(z[k]) for k in FIELDS})
    return state_from_numpy(arrays, device, dtype=cfg.dtype), cfg


# -- the sharded checkpoint (the orbax pair's counterpart) ----------------

SHARDED_INDEX = "index.json"
SHARDED_FORMAT = "fluidsim_tpu_torch sharded checkpoint 1"
# The z axis of each stored array: the fields' first, the velocity's second.
Z_AXIS = {"density": 0, "velocity": 1, "pressure": 0, "obstacles": 0}


def save_checkpoint_sharded(path: str, state, cfg: SimConfig) -> None:
    """Write ``state`` (a ``FluidState`` or a ``parallel.ShardedState``) and
    ``cfg`` as a sharded checkpoint: the counterpart of the JAX package's
    ``save_checkpoint_orbax``, which keeps the state's sharding and never
    gathers it onto one host.

    ``path`` becomes a directory holding one ``<field>.<r>.npy`` a field
    (density, velocity, pressure, obstacles) a slab r (a ``FluidState`` is
    one slab), each written from its shard's device with one slab on the
    host at a time; ``step.npy`` and ``time.npy``; and ``index.json`` (n,
    the fields' dtype, the shard count, each slab's ``z0`` and depth).  The
    config goes to ``path + ".config.json"``, as the orbax pair writes it.
    bfloat16 fields are stored as their raw 16-bit patterns (``uint16``,
    the dtype in the index), so the round trip is bitwise; the ``.npz`` pair
    widens them to float32, which the JAX package can read.  A checkpoint
    already at ``path`` is replaced."""
    slabs = getattr(state, "slabs", None)
    sharded = slabs is not None
    if not sharded:
        slabs = (state,)
    dtype = str(slabs[0].density.dtype).replace("torch.", "")
    os.makedirs(path, exist_ok=True)
    index_path = os.path.join(path, SHARDED_INDEX)
    if os.path.exists(index_path):
        with open(index_path) as f:
            old = json.load(f)
        os.remove(index_path)
        for name in old.get("files", []):
            stale = os.path.join(path, name)
            if os.path.exists(stale):
                os.remove(stale)
    files, z0s, lzs = [], [], []
    for r, slab in enumerate(slabs):
        z0s.append(int(getattr(slab, "z0", 0)))
        lzs.append(int(slab.density.shape[0]))
        for name in Z_AXIS:
            t = getattr(slab, name)
            if sharded and name == "obstacles":
                t = t[1:-1]  # the shard's own planes, not its halo
            files.append(f"{name}.{r}.npy")
            np.save(os.path.join(path, files[-1]), to_bits(t))
    for name in ("step", "time"):
        files.append(f"{name}.npy")
        np.save(os.path.join(path, files[-1]), to_bits(getattr(slabs[0], name)))
    index = {"format": SHARDED_FORMAT, "n": sum(lzs), "dtype": dtype, "shards": len(slabs),
             "z0": z0s, "lz": lzs, "z_axis": Z_AXIS, "files": files}
    with open(index_path, "w") as f:
        json.dump(index, f, indent=1)
    save_config(path + ".config.json", cfg)


def _read_planes(path: str, index: dict, name: str, lo: int, hi: int) -> torch.Tensor:
    """Global planes ``[lo, hi)`` of field ``name`` (clipped to the grid), on
    the host, read from the slabs that hold them (memory-mapped: only those
    planes are read)."""
    axis = index["z_axis"][name]
    dtype = "bool" if name == "obstacles" else index["dtype"]
    parts = []
    for r, (z0, lz) in enumerate(zip(index["z0"], index["lz"])):
        a, b = max(lo, z0), min(hi, z0 + lz)
        if a < b:
            mm = np.load(os.path.join(path, f"{name}.{r}.npy"), mmap_mode="r")
            sel = [slice(None)] * mm.ndim
            sel[axis] = slice(a - z0, b - z0)
            parts.append(from_bits(np.array(mm[tuple(sel)]), dtype))
    return torch.cat(parts, dim=axis)


def load_checkpoint_sharded(path: str, mesh=None, device="cuda"):
    """Read a checkpoint of ``save_checkpoint_sharded``: the counterpart of
    the JAX package's ``load_checkpoint_orbax``.

    With ``mesh=None`` returns ``(FluidState, SimConfig)``, the state on
    ``device``, each slab copied into its place with one slab on the host
    at a time.  With a mesh (``parallel.make_mesh``) returns ``(ShardedState,
    SimConfig)`` on that mesh, of any shard count that divides n: shard r
    reads only its planes (and one plane of the mask past each edge, its
    halo), whatever the shard count that wrote them."""
    with open(os.path.join(path, SHARDED_INDEX)) as f:
        index = json.load(f)
    if index.get("format") != SHARDED_FORMAT:
        raise ValueError(f"{path}: not a sharded checkpoint ({index.get('format')!r})")
    cfg = load_config(path + ".config.json")
    n = index["n"]
    step = from_bits(np.load(os.path.join(path, "step.npy")), "int32")
    time = from_bits(np.load(os.path.join(path, "time.npy")), "float32")
    if mesh is None:
        device = torch.device(device)
        out = {}
        for name, axis in Z_AXIS.items():
            first = _read_planes(path, index, name, 0, index["lz"][0])
            shape = list(first.shape)
            shape[axis] = n
            full = torch.empty(shape, dtype=first.dtype, device=device)
            for z0, lz in zip(index["z0"], index["lz"]):
                part = first if z0 == 0 else _read_planes(path, index, name, z0, z0 + lz)
                full.narrow(axis, z0, lz).copy_(part)
            out[name] = full
        return FluidState(step=step.to(device), time=time.to(device), **out), cfg

    from ..parallel.sharding import ShardedState, SlabState, _own

    k = len(mesh.devices)
    if n % k:
        raise ValueError(f"z extent {n} not divisible by {k} shards")
    lz = n // k
    slabs = []
    for r, dev in enumerate(mesh.devices):
        z0 = r * lz
        fields = {name: _read_planes(path, index, name, z0, z0 + lz).to(dev)
                  for name in FIELDS}
        mask = _read_planes(path, index, "obstacles", max(z0 - 1, 0), min(z0 + lz + 1, n))
        mask = torch.nn.functional.pad(mask, (0, 0, 0, 0, int(z0 == 0), int(z0 + lz == n)))
        slabs.append(SlabState(obstacles=mask.to(dev), step=_own(step, dev),
                               time=_own(time, dev), rank=r, z0=z0, **fields))
    return ShardedState(tuple(slabs)), cfg


# -- config (de)serialization ------------------------------------------

def config_to_json(cfg: SimConfig) -> str:
    d = dataclasses.asdict(cfg)
    d["obstacle_shape"] = int(cfg.obstacle_shape)
    d["color_mode"] = int(cfg.color_mode)
    return json.dumps(d, indent=2)


def config_from_json(s: str) -> SimConfig:
    d = json.loads(s)
    d["obstacle_shape"] = ObstacleShape(d["obstacle_shape"])
    d["color_mode"] = ColorMode(d["color_mode"])
    for key in ("source_position", "obstacle_position", "source_velocity_dir",
                "gradient_times"):
        if key in d:
            d[key] = tuple(d[key])
    if "extra_sources" in d:
        d["extra_sources"] = tuple(
            SourceSpec(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in spec.items()})
            for spec in d["extra_sources"]
        )
    for key in list(d):
        if key.endswith("_color") or key in ("fluid_color", "gradient_colors"):
            v = d[key]
            if isinstance(v, list):
                d[key] = tuple(tuple(c) if isinstance(c, list) else c for c in v)
    return SimConfig(**d)


def save_config(path: str, cfg: SimConfig) -> None:
    with open(path, "w") as f:
        f.write(config_to_json(cfg))


def load_config(path: str) -> SimConfig:
    with open(path) as f:
        return config_from_json(f.read())
