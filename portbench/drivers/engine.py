"""Cells that step the whole volume through ``Engine.step``, the entry of
``cli run`` and of the live viewer: one call advances the cell's
``steps_per_dispatch`` steps, dispatched ahead in one call as ``cli run``
dispatches them; a frame renders the state with ``render_frame_3d``, as the
live viewer's loop does before its PNG encoding."""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.render.raymarch import render_frame_3d


class Driver:
    def __init__(self, cfg, cell: dict, inputs: dict, device):
        self.engine = Engine(cfg, device)
        st = self.engine.state
        dt = st.density.dtype
        self.engine.state = st.replace(density=inputs["density"].to(dt),
                                       velocity=inputs["velocity"].to(dt))
        self.steps = int(cell["steps_per_dispatch"])
        self.devices = [torch.device(device)]

    @property
    def state(self):
        return self.engine.state

    def dispatch(self) -> None:
        self.engine.step(self.steps, substeps_per_dispatch=self.steps)

    def render(self) -> torch.Tensor:
        return render_frame_3d(self.engine.state, self.engine.cfg)

    @staticmethod
    def fields(state) -> dict:
        """The state's density, velocity and pressure as float32 volumes."""
        return {k: getattr(state, k).float() for k in ("density", "velocity", "pressure")}
