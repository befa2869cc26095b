"""Simulation configuration (a copy of ``fluidsim_tpu/config.py``).

This module is copied, not imported: importing ``fluidsim_tpu.config`` runs
``fluidsim_tpu/__init__.py``, which imports JAX.  The fields, defaults,
validation rules and presets are the same as the JAX package's, field for
field (tests/test_torch_config.py holds the two equal); the reasoning behind
each preset's values is documented there.

Mirrors the reference's Unity-Inspector parameter surface (FluidSim.cs:12-110)
as a frozen, hashable dataclass.  Ranges from the reference's ``[Range]``
attributes are enforced in ``validate()``; the auto-adjust rule
(FluidSim.cs:216-222, 554-556) lives in ``effective_params``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np


class ColorMode(enum.IntEnum):
    """FluidSim.cs:32 — enum ColorMode."""

    SINGLE_COLOR = 0
    GRADIENT = 1
    DENSITY_BASED = 2
    PRESSURE_BASED = 3
    STREAMLINES = 4


class ObstacleShape(enum.IntEnum):
    """FluidSim.cs:98 — enum ObstacleShape."""

    CIRCLE = 0
    RECTANGLE = 1
    AIRFOIL = 2


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One additional continuous emitter beyond the reference's single
    source (FluidSim.cs:34-55)."""

    position: Tuple[float, ...] = (0.5, 0.5, 0.5)  # normalized
    strength: float = 100.0
    radius: float = 1.0
    emits_velocity: bool = False
    velocity: float = 10.0
    direction: float = 0.0                  # degrees, 2D mode
    velocity_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0)  # 3D mode
    pulsing: bool = False
    pulse_rate: float = 1.0


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full parameter surface of the reference simulation.

    All defaults equal the reference's C# field initializers
    (FluidSim.cs:12-110), which are also scene preset B.
    """

    # -- core solver (FluidSim.cs:19-31) --------------------------------
    size: int = 128                     # [Range(32, 512)] per-axis grid size
    physical_size: float = 1.0          # physical extent of the domain
    resolution_multiplier: float = 1.0  # [Range(0.1, 10)]
    diffusion: float = 1e-4
    viscosity: float = 1e-4
    time_step: float = 0.1
    auto_adjust_parameters: bool = True
    apply_turbulent_noise: bool = False

    # -- dimensionality -------------------------------------------------
    ndim: int = 2                       # 2 = reference-parity mode, 3 = voxel engine
    jacobi_iters: int = 20              # the reference hard-codes 20
    double_diffuse: bool = True         # the reference's 40-sweep Diffuse()
    double_project: bool = False        # the reference projects twice
    # 3D advection: 0 = exact 8-tap trilinear gather, K>0 = windowed
    # hat-weight sum with the displacement clamped to K cells.
    advect_window: int = 0

    # -- 3D-only physics ------------------------------------------------
    buoyancy: float = 0.0
    ambient_density: float = 0.0
    vorticity_confinement: float = 0.0
    gravity: float = 0.0
    # Stam's implicit sinks: density *= 1/(1 + dt·density_dissipation),
    # velocity *= 1/(1 + dt·velocity_damping) after the projection.
    density_dissipation: float = 0.0
    velocity_damping: float = 0.0

    # -- custom source (FluidSim.cs:34-55) ------------------------------
    enable_custom_source: bool = False
    source_strength: float = 100.0      # [Range(1, 500)]
    source_emits_velocity: bool = False
    source_direction: float = 0.0       # degrees [Range(0, 360)]
    source_velocity: float = 10.0       # [Range(1, 50)]
    source_radius: float = 1.0          # [Range(0.1, 10)]
    source_pulse_rate: float = 1.0      # [Range(0.1, 5)]
    source_pulsing: bool = False
    source_position: Tuple[float, ...] = (0.5, 0.5)  # normalized (x, y[, z])
    # "sim": pulse phase from accumulated simulation time; "wall": from
    # wall-clock frame deltas while unpaused (FluidSim.cs:394,492-494).
    pulse_clock: str = "sim"
    source_velocity_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    extra_sources: Tuple["SourceSpec", ...] = ()

    # -- obstacle (FluidSim.cs:96-110) ----------------------------------
    enable_obstacle: bool = True
    obstacle_shape: ObstacleShape = ObstacleShape.CIRCLE
    obstacle_position: Tuple[float, ...] = (0.5, 0.5)  # normalized
    obstacle_radius: float = 0.1        # [Range(0.01, 0.5)]
    obstacle_width: float = 0.2         # [Range(0.01, 0.5)]
    obstacle_height: float = 0.2        # [Range(0.01, 0.5)]

    # -- visualization (FluidSim.cs:57-94) ------------------------------
    color_mode: ColorMode = ColorMode.SINGLE_COLOR
    fluid_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    colour_intensity: float = 1.0
    use_lerp: bool = False
    start_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    end_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    low_pressure_color: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    neutral_pressure_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    high_pressure_color: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 1.0)
    low_pressure_threshold: float = -50.0
    high_pressure_threshold: float = 50.0
    low_density_color: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    medium_density_color: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)
    high_density_color: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 1.0)
    medium_density_threshold: float = 50.0
    high_density_threshold: float = 200.0
    obstacle_color: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    source_position_color: Tuple[float, float, float, float] = (1.0, 0.92, 0.016, 1.0)
    visualize_source_position: bool = True
    show_streamlines: bool = False
    streamline_density: int = 4         # [Range(1, 5)]
    streamline_scale: float = 1.0       # [Range(1, 10)]
    streamline_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    streamline_thickness: float = 1.0   # [Range(0.1, 3)]
    gradient_colors: Tuple[Tuple[float, float, float, float], ...] = (
        (0.0, 0.0, 1.0, 1.0),
        (1.0, 0.0, 0.0, 1.0),
    )  # default blue→red gradient fabricated in Start() (FluidSim.cs:188-203)
    gradient_times: Tuple[float, ...] = (0.0, 1.0)

    # -- logging (FluidSim.cs:12-17) ------------------------------------
    enable_runtime_logging: bool = True
    logging_interval: int = 10

    # -- numerics -------------------------------------------------------
    dtype: str = "float32"
    # Storage dtype of the pressure solve's iterate and rhs on the fused
    # projection kernel ("float32" or "bfloat16"); the sweep arithmetic
    # stays float32.  Other paths solve in float32.
    solve_dtype: str = "float32"
    jacobi_sweep_block: int = 1         # Jacobi sweeps per pass (1 = sequential)
    # "semi_lagrangian", "maccormack" or "substep".
    advection_scheme: str = "semi_lagrangian"
    advect_substeps: int = 2
    pressure_solver: str = "jacobi"     # "jacobi" or "fft"
    # "auto": hand kernels where usable; "xla": the plain path (the
    # correctness oracle); "pallas": require the hand kernels.
    kernel_backend: str = "auto"
    # Fuse the density advection into the projection kernel.
    fuse_project_advect: bool = False
    # Additionally fuse the velocity self-advection into that kernel.
    fuse_self_advect: bool = False
    # Fold the buoyancy/gravity force into the self-advection kernel.
    fuse_buoyancy: bool = True
    # Fold the main emitter's density add into the kernels' density loads.
    fuse_emitter: bool = False

    # ------------------------------------------------------------------

    @property
    def current_size(self) -> int:
        """currentSize = round(size * resolutionMultiplier) (FluidSim.cs:216).

        Uses round-half-up like Unity's Mathf.RoundToInt-on-positive values.
        """
        return int(math.floor(self.size * self.resolution_multiplier + 0.5))

    @property
    def cell_size(self) -> float:
        """cellSize = physicalSize / currentSize (FluidSim.cs:219), in f32."""
        return float(np.float32(self.physical_size) / np.float32(self.current_size))

    @property
    def dt_scale(self) -> float:
        """dtScale = 128 / currentSize when auto-adjusting (FluidSim.cs:222)."""
        if not self.auto_adjust_parameters:
            return 1.0
        return float(np.float32(128.0) / np.float32(self.current_size))

    def effective_params(self) -> Tuple[float, float, float]:
        """(dt, diffusion, viscosity) after auto-adjust (FluidSim.cs:554-556).

        All arithmetic in float32 to match the reference.
        """
        if self.auto_adjust_parameters:
            dt = np.float32(self.time_step) * np.float32(self.dt_scale)
            diff = np.float32(self.diffusion) / np.float32(self.resolution_multiplier)
            visc = np.float32(self.viscosity) / np.float32(self.resolution_multiplier)
        else:
            dt = np.float32(self.time_step)
            diff = np.float32(self.diffusion)
            visc = np.float32(self.viscosity)
        return float(dt), float(diff), float(visc)

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.current_size,) * self.ndim

    def validate(self) -> "SimConfig":
        """Enforce the reference's [Range] clamps; raise on structural errors."""
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if not (32 <= self.size <= 512):
            raise ValueError(f"size out of [32, 512]: {self.size}")
        if not (0.1 <= self.resolution_multiplier <= 10.0):
            raise ValueError(
                f"resolution_multiplier out of [0.1, 10]: {self.resolution_multiplier}"
            )
        if len(self.source_position) != self.ndim:
            raise ValueError("source_position length must equal ndim")
        if len(self.obstacle_position) != self.ndim:
            raise ValueError("obstacle_position length must equal ndim")
        if self.jacobi_iters < 1:
            raise ValueError("jacobi_iters must be >= 1")
        if self.pulse_clock not in ("sim", "wall"):
            raise ValueError(
                f"pulse_clock must be 'sim' or 'wall', got {self.pulse_clock!r}"
            )
        if self.solve_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"solve_dtype must be 'float32' or 'bfloat16', "
                f"got {self.solve_dtype!r}"
            )
        if self.jacobi_sweep_block < 1:
            raise ValueError(
                f"jacobi_sweep_block must be >= 1, "
                f"got {self.jacobi_sweep_block}"
            )
        return self

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# Scene presets — the two serialized FluidSimulation instances.
# ----------------------------------------------------------------------

def preset_scene_a() -> SimConfig:
    """Instance A "Fluid Simulation" (SampleScene.unity:242-343).

    192² effective grid (size 64 × resMult 3), airfoil obstacle, pulsing
    directional emitter at (0.1, 0.5), DensityBased coloring.
    """
    return SimConfig(
        size=64,
        physical_size=2.0,
        resolution_multiplier=3.0,
        diffusion=1e-4,
        viscosity=1e-5,
        time_step=0.0025,
        enable_custom_source=True,
        source_strength=122.0,
        source_emits_velocity=True,
        source_direction=0.0,
        source_velocity=36.4,
        source_radius=6.2,
        source_pulse_rate=5.0,
        source_position=(0.1, 0.5),
        enable_obstacle=True,
        obstacle_shape=ObstacleShape.AIRFOIL,
        obstacle_position=(0.5, 0.5),
        obstacle_radius=0.1,
        obstacle_width=0.2,
        obstacle_height=0.05,
        color_mode=ColorMode.DENSITY_BASED,
        logging_interval=30,
    ).validate()


def preset_scene_b() -> SimConfig:
    """Instance B (SampleScene.unity:518-612) — the stock C# defaults."""
    return SimConfig().validate()


# ----------------------------------------------------------------------
# 3D workload presets — the five BASELINE.json configs.
# ----------------------------------------------------------------------

def preset_smoke_box_32() -> SimConfig:
    """32³ smoke box: single dye emitter, 20-iter Jacobi projection."""
    return SimConfig(
        ndim=3,
        size=32,
        time_step=0.05,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        enable_custom_source=True,
        source_strength=120.0,
        source_emits_velocity=True,
        source_velocity=20.0,
        source_radius=2.5,
        source_position=(0.5, 0.15, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
    ).validate()


def preset_plume_64() -> SimConfig:
    """64³ smoke plume with buoyancy + viscous diffusion solve."""
    return SimConfig(
        ndim=3,
        size=64,
        time_step=0.04,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=1e-4,
        double_diffuse=False,
        buoyancy=1.0,
        ambient_density=0.0,
        enable_custom_source=True,
        source_strength=150.0,
        source_radius=4.0,
        source_position=(0.5, 0.08, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
        advect_window=3,
    ).validate()


def preset_vortex_128() -> SimConfig:
    """128³ with vorticity confinement + static solid obstacle; three
    K=1 sub-advections, bf16 solve buffers, unfused projection."""
    return SimConfig(
        ndim=3,
        size=128,
        time_step=0.03,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=1.0,
        vorticity_confinement=2.0,
        enable_custom_source=True,
        source_strength=150.0,
        source_radius=6.0,
        source_position=(0.5, 0.08, 0.5),
        enable_obstacle=True,
        obstacle_shape=ObstacleShape.CIRCLE,
        obstacle_position=(0.5, 0.45, 0.5),
        obstacle_radius=0.08,
        jacobi_iters=20,
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=3,
        solve_dtype="bfloat16",
    ).validate()


def preset_multi_emitter_256() -> SimConfig:
    """256³ multi-emitter scene with a volumetric raymarch render."""
    return SimConfig(
        ndim=3,
        size=256,
        time_step=0.02,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=0.8,
        vorticity_confinement=1.5,
        enable_custom_source=True,
        source_strength=150.0,
        source_radius=10.0,
        source_position=(0.3, 0.1, 0.3),
        extra_sources=(
            SourceSpec(position=(0.7, 0.1, 0.7), strength=150.0,
                       radius=10.0, emits_velocity=True, velocity=8.0,
                       velocity_dir=(0.0, 1.0, 0.0)),
            SourceSpec(position=(0.7, 0.12, 0.3), strength=100.0,
                       radius=8.0, pulsing=True, pulse_rate=2.0),
        ),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=2,
        fuse_project_advect=True,
    ).validate()


def preset_sharded_512() -> SimConfig:
    """512³ scene that the JAX package shards along z across devices."""
    return SimConfig(
        ndim=3,
        size=512,
        time_step=0.01,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=0.8,
        enable_custom_source=True,
        source_strength=200.0,
        source_radius=20.0,
        source_position=(0.5, 0.05, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=2,
    ).validate()


def preset_bench_128() -> SimConfig:
    """The headline benchmark config: 128³, 60-iter Jacobi projection.

    One K=1 semi-Lagrangian backtrace per step (the scene's dt keeps the
    displacement within one cell), buoyancy, density/velocity sinks, one
    emitter, the density advection fused into the projection, and bf16
    solve buffers with float32 sweep arithmetic.
    """
    return SimConfig(
        ndim=3,
        size=128,
        time_step=0.0008,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=0.2,
        enable_custom_source=True,
        source_strength=8.0,
        source_radius=6.0,
        source_position=(0.5, 0.08, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=60,
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=1,
        density_dissipation=5.0,
        velocity_damping=3.0,
        fuse_project_advect=True,
        solve_dtype="bfloat16",
    ).validate()


PRESETS = {
    "scene_a": preset_scene_a,
    "scene_b": preset_scene_b,
    "smoke32": preset_smoke_box_32,
    "plume64": preset_plume_64,
    "vortex128": preset_vortex_128,
    "multi256": preset_multi_emitter_256,
    "sharded512": preset_sharded_512,
    "bench128": preset_bench_128,
}


def get_preset(name: str) -> SimConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
