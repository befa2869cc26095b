"""The simulation engine (counterpart of ``fluidsim_tpu/engine.py``).

The host-side equivalent of the reference's ``Update()`` loop
(FluidSim.cs:390-450): emitter injection then one solver step, per step, in
a Python loop: ``models.stable2d.simulate_step_2d`` for the 2D
reference-parity mode (``ndim=2``), ``models.stable3d.simulate_step_3d``
for the 3D engine (where ``stable3d.emitter_folds`` holds, the emitter
folded into the step's kernels, as the JAX ``Engine`` does); pause, reset,
source repositioning, mouse drag (``scene.interact``), metrics logged every
``logging_interval`` steps to a ``metrics.MetricsStore`` with the
reference's smoothed frame rate, checkpoints (``io.checkpoint``) and an
optional NaN guard that can dump the last good state before it raises.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import SimConfig
from .io.checkpoint import load_checkpoint, save_checkpoint
from .kernels.project import resident_route
from .metrics import FrameRateTracker, MetricsStore, compute_metrics
from .models import stable3d
from .models.stable2d import simulate_step_2d
from .models.stable3d import simulate_step_3d
from .models.step_kernels import HAND_KERNELS, StepKernels
from .scene.interact import add_force_to_area, mouse_drag_force
from .scene.obstacles import build_obstacle_mask
from .scene.sources import (
    apply_custom_source,
    emitter_fold_operand,
    emitter_fold_values,
    source_params,
)
from .state import FluidState, zeros_state
from .utils.profiling import span


class Engine:
    """Steps a 2D (reference-parity) or 3D fluid simulation on ``device``
    (the card unless the caller asks for ``"cpu"``) from the host."""

    def __init__(self, cfg: SimConfig, device="cuda", nan_guard: bool = False,
                 store: Optional[MetricsStore] = None,
                 crash_snapshot_path: Optional[str] = None,
                 kernels: StepKernels = HAND_KERNELS):
        """``store`` records the run (``run_id``; -1 without a store, or for
        a run the store refuses) and its metrics every ``logging_interval``
        steps.  ``crash_snapshot_path``: with ``nan_guard``, the last good
        state is saved there before the guard raises (resume with
        ``Engine.from_checkpoint``).  ``kernels`` replaces the kernel path's
        calls (see ``models.stable3d.simulate_step_3d``)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to step on the CPU")
        self.kernels = kernels
        self.nan_guard = nan_guard
        self.crash_snapshot_path = crash_snapshot_path
        self._last_good: Optional[FluidState] = None
        self.paused = False
        self._clock = time.perf_counter  # swappable for tests
        self.cfg = self._checked(cfg)
        self.store = store
        self.run_id = store.save_run_params(cfg) if store is not None else -1
        self._fps = FrameRateTracker()
        self.reset()

    def _checked(self, cfg: SimConfig) -> SimConfig:
        """Validate ``cfg`` and, in 3D, decide its projection route and
        whether the emitter folds into the kernels on this device once, for
        every step until the next ``set_config``."""
        cfg = cfg.validate()
        if cfg.ndim == 2:
            self._resident, self._folds = None, False
            return cfg
        use_kernels = stable3d._kernels_usable(cfg, self.device)
        self._resident = resident_route(cfg.current_size, cfg.solve_dtype, self.device)
        stable3d.check_supported(cfg, use_kernels)
        self._folds = stable3d.emitter_folds(cfg, use_kernels, self._resident)
        return cfg

    def _set_src_params(self, params) -> None:
        """The emitter's values, and (where it folds) their fixed part of
        the kernels' descriptor on the device, copied once per change."""
        self._src_params = params
        self._fold_values = (
            torch.from_numpy(emitter_fold_values(self.cfg, params)).to(self.device)
            if self._folds else None)

    # -- lifecycle ------------------------------------------------------

    def reset(self) -> None:
        """``ResetSimulation`` (FluidSim.cs:213-300): reallocate fields and
        re-rasterize obstacles from the current config."""
        obst = build_obstacle_mask(self.cfg)
        self.state = zeros_state(self.cfg, self.device, obstacles=obst)
        self._set_src_params(source_params(self.cfg))
        self._host_step = 0
        self._fps_pending = 0  # steps since the last frame-rate tick
        # Wall-clock elapsedTime for pulse_clock="wall" (FluidSim.cs:394):
        # accumulates frame deltas only while unpaused.
        self._elapsed = 0.0
        self._wall_prev: Optional[float] = None

    def set_config(self, cfg: SimConfig) -> None:
        """``OnValidate`` analog (FluidSim.cs:154-180): grid-shape changes
        reset state; parameter-only changes re-rasterize obstacles."""
        old_shape = self.cfg.grid_shape
        self.cfg = self._checked(cfg)
        if cfg.grid_shape != old_shape:
            self.reset()
        else:
            obst = torch.as_tensor(build_obstacle_mask(cfg), device=self.device)
            self.state = self.state.replace(obstacles=obst)
            self._set_src_params(source_params(self.cfg))

    def set_paused(self, paused: bool) -> None:
        """FluidSim.cs:149-153."""
        if self.paused and not paused:
            # Resume: drop the pause gap from the wall-clock accumulator.
            self._wall_prev = None
        self.paused = paused

    # -- stepping -------------------------------------------------------

    def _one_step(self, state: FluidState) -> FluidState:
        t = state.time + self.cfg.effective_params()[0]
        if self._folds:
            with span("engine.source"):
                src = emitter_fold_operand(self.cfg, t, params=self._src_params,
                                           values=self._fold_values)
            return simulate_step_3d(state, self.cfg, self.kernels, self._resident,
                                    src=src)
        with span("engine.source"):
            density, velocity = apply_custom_source(
                state.density, state.velocity, self.cfg, t, params=self._src_params
            )
            state = state.replace(density=density, velocity=velocity)
        if self.cfg.ndim == 2:
            return simulate_step_2d(state, self.cfg, self.kernels)
        return simulate_step_3d(state, self.cfg, self.kernels, self._resident)

    def step(self, n: int = 1, substeps_per_dispatch: int = 1) -> FluidState:
        """Advance ``n`` steps (no-op while paused, FluidSim.cs:392).  The NaN
        guard checks once every ``substeps_per_dispatch`` steps."""
        with span("engine.step"):
            return self._step(n, substeps_per_dispatch)

    def _step(self, n: int, substeps_per_dispatch: int) -> FluidState:
        now = self._clock()
        delta = (now - self._wall_prev) if self._wall_prev is not None else 0.0
        # Unity clamps a frame's deltaTime to its maximum allowed timestep.
        delta = min(delta, 0.33333334)
        self._wall_prev = now
        if self.paused:
            return self.state
        if self.cfg.pulse_clock == "wall":
            self._elapsed += delta
            self._src_params = self._src_params._replace(
                pulse_t=np.float32(self._elapsed)
            )
        dispatches, rem = divmod(n, substeps_per_dispatch)
        for size in [substeps_per_dispatch] * dispatches + [1] * rem:
            for _ in range(size):
                self.state = self._one_step(self.state)
            with span("engine.after"):
                self._after_dispatch(size)
        return self.state

    def _after_dispatch(self, n_steps: int) -> None:
        # The step count is known on the host; reading state.step would
        # synchronise with the device after every dispatch.
        self._fps_pending += n_steps
        self._host_step += n_steps
        step_now = self._host_step
        if self.nan_guard:
            if bool(torch.isnan(self.state.density).any()):
                saved = self.crash_snapshot_path is not None and self._last_good is not None
                if saved:
                    save_checkpoint(self.crash_snapshot_path, self._last_good, self.cfg)
                raise FloatingPointError(
                    f"NaN detected in density at step {step_now}"
                    + (f"; last good state saved to {self.crash_snapshot_path}"
                       if saved else ""))
            if self.crash_snapshot_path is not None:
                self._last_good = self.state
        if (self.store is not None and self.cfg.enable_runtime_logging
                and step_now % max(self.cfg.logging_interval, 1) < n_steps):
            avg, vmax = compute_metrics(self.state.density, self.state.velocity)
            avg_f, vmax_f = float(avg), float(vmax)  # waits for the device
            # The frame rate is measured between metric reads, the only
            # points where the host clock has seen the device finish, over
            # every step since the last one.
            fps = self._fps.tick(frames=self._fps_pending)
            self._fps_pending = 0
            self.store.log_runtime_metrics(self.run_id, step_now, avg_f, vmax_f, fps)

    # -- interaction (FluidSim.cs:390-483, 979-988) ---------------------

    def get_source_position(self) -> Tuple[float, ...]:
        """Grid-coordinate source position (FluidSim.cs:979-982)."""
        n = self.cfg.current_size
        return tuple(p * n for p in self.cfg.source_position)

    def set_source_position(self, *coords: float) -> None:
        """Clamped normalized reposition (FluidSim.cs:984-988)."""
        n = self.cfg.current_size
        pos = tuple(float(np.clip(c / n, 0.0, 1.0)) for c in coords)
        self.cfg = self.cfg.replace(source_position=pos)
        self._set_src_params(self._src_params._replace(
            position=np.asarray(pos[: self.cfg.ndim], np.float32)
        ))

    def drag(self, prev_pos: Sequence[float], cur_pos: Sequence[float]) -> None:
        """Apply one mouse-drag event (FluidSim.cs:414-436) on the device."""
        center, force, radius = mouse_drag_force(tuple(prev_pos), tuple(cur_pos), self.cfg)
        vel, density = add_force_to_area(self.state.velocity, self.state.density, center,
                                         force, radius, self.cfg.source_strength)
        self.state = self.state.replace(velocity=vel, density=density)

    # -- persistence ----------------------------------------------------

    def save_configuration(self) -> int:
        """``SaveCurrentConfiguration`` (FluidSim.cs:2004-2023): a
        SimulationRuns row in the store, or -1 without one."""
        if self.store is None:
            return -1
        return self.store.save_run_params(self.cfg)

    def save_checkpoint(self, path: str) -> None:
        save_checkpoint(path, self.state, self.cfg)

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda", **kw) -> "Engine":
        """An engine on ``device`` that resumes the checkpoint at ``path``
        (its config, state and step count); ``kw`` as for ``Engine``."""
        state, cfg = load_checkpoint(path, device)
        eng = cls(cfg, device, **kw)
        eng.state = state
        eng._host_step = int(state.step)
        return eng
