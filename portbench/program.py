"""What the benchmark takes from the program (``fluidsim_tpu_torch``): its
configuration built from a configuration file, and the launch counters that
it keeps, read before and after a window.  The drivers in ``drivers/`` hold
the calls into its entry points."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def sim_config(sim: dict, overrides: dict = None):
    """The program's ``SimConfig`` of the settings ``sim`` (lists read as
    tuples), with ``overrides`` replaced."""
    from fluidsim_tpu_torch.config import ColorMode, ObstacleShape, SimConfig, SourceSpec

    fields = {k: _tuples(v) for k, v in sim.items()}
    fields["extra_sources"] = tuple(SourceSpec(**{k: _tuples(v) for k, v in s.items()})
                                    for s in sim.get("extra_sources", []))
    fields["color_mode"] = ColorMode(fields.get("color_mode", 0))
    fields["obstacle_shape"] = ObstacleShape(fields.get("obstacle_shape", 0))
    cfg = SimConfig(**fields)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg.validate()


def _counters():
    """The program's counters named in ``counters.json``: ``{name: value}``,
    a dict of counts or one count, those the program has."""
    out = {}
    for path in json.loads((HERE / "counters.json").read_text()):
        module, _, attr = path.partition(":")
        obj = importlib.import_module(module)
        for part in attr.split("."):
            obj = getattr(obj, part, None)
        if isinstance(obj, dict):
            out[path] = dict(obj)
        elif isinstance(obj, int):
            out[path] = obj
    return out


class Counters:
    """The counts the program made between ``start()`` and ``stop()``."""

    def start(self):
        self._before = _counters()

    def stop(self) -> dict:
        after, out = _counters(), {}
        for k, v in after.items():
            b = self._before.get(k)
            if isinstance(v, dict):
                b = b or {}
                out[k] = {kk: vv - b.get(kk, 0) for kk, vv in v.items()}
            else:
                out[k] = v - (b or 0)
        return out
