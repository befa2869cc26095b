"""Runtime metrics and their SQLite store (counterpart of
``fluidsim_tpu/metrics.py``).

Reference: ``LogCurrentMetrics``/``CalculateFrameRate``
(FluidSim.cs:578-615) and the ``SQL`` class (SQL.cs:46-127).

* ``compute_metrics``: the mean density and the largest velocity magnitude
  as 0-d tensors on the fields' device, read once a logging interval.
* ``FrameRateTracker``: the reference's smoothed frame rate (α = 0.9).
* ``MetricsStore``: stdlib ``sqlite3`` with the JAX package's tables,
  columns and rows (SQL.cs:19-40, extended with the columns the INSERT
  statements use, SQL.cs:63-68, 110-114), and its quirks: a run whose
  timestep is float32(0.1), the C# default, is not recorded
  (``skip_default_timestep``, SQL.cs:53-56,71), and a metrics row with a
  zero metric is skipped (FluidSim.cs:597).
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import SimConfig

_SCHEMA = """
CREATE TABLE IF NOT EXISTS SimulationRuns (
    RunID INTEGER PRIMARY KEY AUTOINCREMENT,
    Size INTEGER,
    Diffusion REAL,
    Viscosity REAL,
    TimeStep REAL,
    SourceEnabled INTEGER,
    SourceStrength REAL,
    SourcePositionX REAL,
    SourcePositionY REAL,
    ObstacleEnabled INTEGER,
    ObstacleType TEXT,
    ObstaclePositionX REAL,
    ObstaclePositionY REAL,
    ObstacleRadius REAL,
    ObstacleWidth REAL,
    ObstacleHeight REAL,
    Timestamp DATETIME DEFAULT CURRENT_TIMESTAMP
);
CREATE TABLE IF NOT EXISTS RuntimeMetrics (
    MetricID INTEGER PRIMARY KEY AUTOINCREMENT,
    RunID INTEGER,
    Step INTEGER,
    Timestamp DATETIME DEFAULT CURRENT_TIMESTAMP,
    AverageDensity REAL,
    MaxVelocityMagnitude REAL,
    FrameRate REAL,
    FOREIGN KEY(RunID) REFERENCES SimulationRuns(RunID) ON DELETE CASCADE
);
"""


def compute_metrics(density: torch.Tensor,
                    velocity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean density, max |v|) as 0-d tensors on the fields' device
    (FluidSim.cs:586-594)."""
    avg = torch.mean(density)
    vmax = torch.sqrt(torch.max(torch.sum(velocity * velocity, dim=0)))
    return avg, vmax


class FrameRateTracker:
    """Exponentially smoothed FPS, α = 0.9 (FluidSim.cs:144-145, 609-615)."""

    SMOOTH_FACTOR = 0.9

    def __init__(self):
        self._smoothed = 0.0
        self._last: Optional[float] = None

    def tick(self, now: Optional[float] = None, frames: int = 1) -> float:
        """One EMA update over the interval since the previous tick.
        ``frames`` is how many simulation steps that interval covered —
        the engine ticks once per metrics sync (dispatches pipeline, so
        per-dispatch host intervals would measure enqueue time, not
        device throughput)."""
        now = time.perf_counter() if now is None else now
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = frames / dt
            self._smoothed = (
                self.SMOOTH_FACTOR * self._smoothed
                + (1.0 - self.SMOOTH_FACTOR) * inst
            )
        self._last = now
        return self._smoothed


class MetricsStore:
    """SQLite-backed run/metrics store (the SQL.cs equivalent)."""

    def __init__(self, path: str = "fluidsim.db",
                 skip_default_timestep: bool = True):
        self.path = path
        self.skip_default_timestep = skip_default_timestep
        # The live viewer logs metrics from its sim thread and saves
        # configs from HTTP handler threads; sqlite3 connections are
        # thread-bound by default, so share one under a lock instead.
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute("PRAGMA foreign_keys = ON;")  # init.sql:1
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    # -- SaveSimRunParams (SQL.cs:46-96) --------------------------------
    def save_run_params(self, cfg: SimConfig) -> int:
        """Insert a SimulationRuns row, return RunID (or −1, mirroring the
        reference's refusal to record the float32-0.1 default timestep)."""
        if self.skip_default_timestep and np.float32(cfg.time_step) == np.float32(0.1):
            return -1
        with self._lock:
            return self._save_run_params_locked(cfg)

    def _save_run_params_locked(self, cfg: SimConfig) -> int:
        cur = self._conn.execute(
            """INSERT INTO SimulationRuns
               (Size, Diffusion, Viscosity, TimeStep, SourceEnabled,
                SourceStrength, SourcePositionX, SourcePositionY,
                ObstacleEnabled, ObstacleType, ObstaclePositionX,
                ObstaclePositionY, ObstacleRadius, ObstacleWidth,
                ObstacleHeight)
               VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
            (
                cfg.size,
                cfg.diffusion,
                cfg.viscosity,
                cfg.time_step,
                int(cfg.enable_custom_source),
                cfg.source_strength,
                cfg.source_position[0],
                cfg.source_position[1],
                int(cfg.enable_obstacle),
                cfg.obstacle_shape.name.capitalize(),
                cfg.obstacle_position[0],
                cfg.obstacle_position[1],
                cfg.obstacle_radius,
                cfg.obstacle_width,
                cfg.obstacle_height,
            ),
        )
        self._conn.commit()
        return int(cur.lastrowid)

    # -- LogRuntimeMetrics (SQL.cs:98-127) ------------------------------
    def log_runtime_metrics(self, run_id: int, step: int, avg_density: float,
                            max_velocity: float, frame_rate: float) -> None:
        if run_id == -1:
            return  # FluidSim.cs:580
        # FluidSim.cs:597 skips rows where either metric is zero.
        if max_velocity == 0.0 or avg_density == 0.0:
            return
        with self._lock:
            self._conn.execute(
                """INSERT INTO RuntimeMetrics
                   (RunID, Step, AverageDensity, MaxVelocityMagnitude, FrameRate)
                   VALUES (?, ?, ?, ?, ?)""",
                (run_id, step, avg_density, max_velocity, frame_rate),
            )
            self._conn.commit()

    def fetch_metrics(self, run_id: int):
        with self._lock:
            return self._conn.execute(
                "SELECT Step, AverageDensity, MaxVelocityMagnitude, FrameRate "
                "FROM RuntimeMetrics WHERE RunID = ? ORDER BY MetricID",
                (run_id,),
            ).fetchall()

    def fetch_runs(self):
        with self._lock:
            return self._conn.execute(
                "SELECT RunID, Size, Diffusion, Viscosity, TimeStep, "
                "ObstacleType FROM SimulationRuns ORDER BY RunID"
            ).fetchall()

    def close(self):
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
