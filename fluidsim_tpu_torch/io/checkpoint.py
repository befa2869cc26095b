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
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from ..config import ColorMode, ObstacleShape, SimConfig, SourceSpec
from ..state import FluidState
from .convert import FIELDS, state_from_numpy, state_to_numpy


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
