"""Cells that step a mesh of z-slab shards through the step that
``parallel.sharding.sharded_step_fn`` returns: the cell's ``shards`` slabs,
``cards`` cards (shard r on card ⌊r·cards/shards⌋; on the CPU every shard on
the CPU), the halo strategy, backend and block of the cell, one call
advancing ``steps_per_dispatch`` steps."""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn, unshard_state
from fluidsim_tpu_torch.state import zeros_state


class Driver:
    def __init__(self, cfg, cell: dict, inputs: dict, device):
        device = torch.device(device)
        k, cards = int(cell["shards"]), int(cell["cards"])
        if device.type == "cuda":
            devices = [torch.device("cuda", r * cards // k) for r in range(k)]
        else:
            devices = [device] * k
        self.mesh = make_mesh(devices)
        self.steps = int(cell["steps_per_dispatch"])
        self._step = sharded_step_fn(cfg, self.mesh, n_substeps=self.steps,
                                     halo=cell["halo"],
                                     halo_block_iters=int(cell["halo_block_iters"]),
                                     halo_backend=cell["halo_backend"])
        st = zeros_state(cfg, devices[0])
        dt = st.density.dtype
        self._state = shard_state(st.replace(density=inputs["density"].to(dt),
                                             velocity=inputs["velocity"].to(dt)), self.mesh)
        self.devices = sorted(set(devices), key=str)

    @property
    def state(self):
        return self._state

    def dispatch(self) -> None:
        self._state = self._step(self._state)

    def render(self) -> torch.Tensor:
        raise NotImplementedError("the sharded driver renders no frame")

    @staticmethod
    def fields(state) -> dict:
        """The global density, velocity and pressure as float32 volumes on
        the first shard's device."""
        g = unshard_state(state)
        return {k: getattr(g, k).float() for k in ("density", "velocity", "pressure")}
