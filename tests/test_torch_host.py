"""The host layer of fluidsim_tpu_torch against the JAX package, on the CPU:
checkpoints and config files (each package loads what the other writes,
float32 and bfloat16 states), the SQLite metrics store (the same rows for
the same run), ``compute_metrics``, the point injectors, the drag force and
``Engine.drag`` (2D scene_a and 3D), the 2D colormap and streamlines, the
HTML export, and the live viewer's server.

Tolerances, each with its reason:

* checkpoints, configs, the store's run rows and frame-rate column, the
  point injectors, the rasterized streamlines and the HTML file: equal (the
  same values, the same bytes);
* ``compute_metrics`` and the store's metric columns after a run: rtol 1e-5
  (float32 sums in another order; the run itself is the step class of
  tests/test_torch_step.py, rtol 1e-5, atol 1e-6·max|ref|);
* the drag force: the 2D per-op class of tests/test_torch_2d.py (rtol
  2e-6, atol 1e-6·max|ref|) and the 3D step class (rtol 1e-5, atol
  1e-6·max|ref|): XLA on the CPU may contract the distance's squares into
  an FMA;
* ``render_frame_2d`` and the streamline segments: rtol 1e-6 (atol 1e-6 for
  values near zero): the same float32 operations, with XLA's FMAs and its
  own ``atan2``/``cos``/``sin``.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.config as j_config
import fluidsim_tpu.io.checkpoint as j_ckpt
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.metrics import FrameRateTracker as JTracker
from fluidsim_tpu.metrics import MetricsStore as JStore
from fluidsim_tpu.metrics import compute_metrics as j_metrics
from fluidsim_tpu.render import colormap as j_cmap
from fluidsim_tpu.render import streamlines as j_stream
from fluidsim_tpu.render.viewer import export_html as j_export_html
from fluidsim_tpu.scene import interact as j_interact
from fluidsim_tpu.scene import sources as j_sources
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.config as t_config
import fluidsim_tpu_torch.io.checkpoint as t_ckpt
from fluidsim_tpu_torch.config import ColorMode, SimConfig
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.metrics import FrameRateTracker, MetricsStore, compute_metrics
from fluidsim_tpu_torch.render import colormap as t_cmap
from fluidsim_tpu_torch.render import streamlines as t_stream
from fluidsim_tpu_torch.render.live import LiveServer
from fluidsim_tpu_torch.render.viewer import export_html
from fluidsim_tpu_torch.scene import interact as t_interact
from fluidsim_tpu_torch.scene import sources as t_sources

torch.set_num_threads(1)

FIELDS = ("density", "velocity", "pressure")


def both(name, **change):
    """The JAX and the port's config of preset ``name`` with ``change``."""
    return (getattr(j_config, name)().replace(**change),
            getattr(t_config, name)().replace(**change))


def seeded_arrays(cfg, seed=7):
    rng = np.random.default_rng(seed)
    shape = cfg.grid_shape
    arrays = {
        "density": np.abs(rng.standard_normal(shape) * 20).astype(np.float32),
        "velocity": rng.standard_normal((cfg.ndim,) + shape).astype(np.float32),
        "pressure": rng.standard_normal(shape).astype(np.float32),
        "obstacles": rng.random(shape) < 0.05,
        "step": np.asarray(12, np.int32),
        "time": np.asarray(0.6, np.float32),
    }
    if cfg.dtype == "bfloat16":  # values a bfloat16 field holds
        for k in FIELDS:
            arrays[k] = torch.from_numpy(arrays[k]).bfloat16().float().numpy()
    return arrays


def jax_state(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return JState(**{k: jnp.asarray(v, jdt) if k in FIELDS else jnp.asarray(v)
                     for k, v in arrays.items()})


def same_config(a, b):
    assert json.loads(j_ckpt.config_to_json(a)) == json.loads(t_ckpt.config_to_json(b))


# -- checkpoints and configs ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_load_across_packages(tmp_path, dtype):
    """A JAX checkpoint loads in the port with equal arrays (bfloat16 fields,
    which the JAX package stores as raw two-byte records, as bfloat16) and
    an equal config; a port checkpoint loads in the JAX package (bfloat16
    fields as float32 arrays of the same values) and in the port itself
    bitwise, in its dtype."""
    j_cfg, t_cfg = both("preset_smoke_box_32", dtype=dtype)
    arrays = seeded_arrays(t_cfg)
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_ckpt.save_checkpoint(j_path, jax_state(arrays, dtype), j_cfg)
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    state, cfg = t_ckpt.load_checkpoint(j_path, "cpu")
    same_config(j_cfg, cfg)
    assert cfg == t_cfg
    got = state_to_numpy(state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert all(getattr(state, k).dtype == fdt for k in FIELDS)

    ours = state_from_numpy(arrays, "cpu", dtype=dtype)
    t_ckpt.save_checkpoint(t_path, ours, t_cfg)
    j_state, j_loaded = j_ckpt.load_checkpoint(t_path)
    same_config(j_loaded, t_cfg)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(j_state, k), v.dtype), v, err_msg=k)
    back, cfg = t_ckpt.load_checkpoint(t_path, "cpu")
    assert cfg == t_cfg
    for k in arrays:
        assert torch.equal(getattr(back, k), getattr(ours, k)), k


@pytest.mark.parametrize("name", sorted(t_config.PRESETS))
def test_config_files_are_the_jax_package_text(tmp_path, name):
    """``config_to_json`` writes the JAX package's text for every preset,
    and each package's config file loads in the other to an equal config."""
    j_cfg = j_config.PRESETS[name]()
    t_cfg = t_config.PRESETS[name]()
    assert t_ckpt.config_to_json(t_cfg) == j_ckpt.config_to_json(j_cfg)
    j_ckpt.save_config(str(tmp_path / "j.json"), j_cfg)
    t_ckpt.save_config(str(tmp_path / "t.json"), t_cfg)
    assert t_ckpt.load_config(str(tmp_path / "j.json")) == t_cfg
    same_config(j_ckpt.load_config(str(tmp_path / "t.json")), t_cfg)
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()


# -- metrics --------------------------------------------------------------------


def ticking(engine, tracker_cls):
    """Give ``engine``'s frame-rate tracker a clock of 0.25 s a tick."""
    clock = iter(np.arange(0.0, 100.0, 0.25))
    engine._fps.tick = lambda frames=1: tracker_cls.tick(engine._fps, now=float(next(clock)),
                                                         frames=frames)


def test_metrics_store_rows_like_jax(tmp_path):
    """The same run (smoke32 cut to 32³ with a source of velocity, 7 steps,
    metrics every 2 steps) recorded by each package's engine in its store:
    the same SimulationRuns row and the same RuntimeMetrics rows."""
    change = dict(size=32, logging_interval=2, time_step=0.05)
    j_cfg, t_cfg = both("preset_smoke_box_32", **change)
    with JStore(str(tmp_path / "j.db")) as j_store, \
            MetricsStore(str(tmp_path / "t.db")) as t_store:
        j_eng = JEngine(j_cfg, store=j_store)
        t_eng = Engine(t_cfg, "cpu", store=t_store)
        assert j_eng.run_id == t_eng.run_id == 1
        ticking(j_eng, JTracker)
        ticking(t_eng, FrameRateTracker)
        for eng in (j_eng, t_eng):
            eng.step(3)
            eng.step(4, substeps_per_dispatch=2)
        assert t_eng.save_configuration() == j_eng.save_configuration() == 2
        cols = ("Size, Diffusion, Viscosity, TimeStep, SourceEnabled, SourceStrength, "
                "SourcePositionX, SourcePositionY, ObstacleEnabled, ObstacleType, "
                "ObstaclePositionX, ObstaclePositionY, ObstacleRadius, ObstacleWidth, "
                "ObstacleHeight")
        runs = [s._conn.execute(f"SELECT RunID, {cols} FROM SimulationRuns").fetchall()
                for s in (j_store, t_store)]
        assert runs[0] == runs[1] and len(runs[1]) == 2
        j_rows, t_rows = j_store.fetch_metrics(1), t_store.fetch_metrics(1)
        assert [r[0] for r in t_rows] == [r[0] for r in j_rows] == [2, 5, 7]
        assert [r[3] for r in t_rows] == [r[3] for r in j_rows]
        np.testing.assert_allclose([r[1:3] for r in t_rows], [r[1:3] for r in j_rows],
                                   rtol=1e-5)


def test_nan_guard_saves_the_last_good_state(tmp_path):
    """With ``nan_guard`` and ``crash_snapshot_path`` the engine saves the
    last good state before it raises, and ``Engine.from_checkpoint``
    resumes from it (the JAX engine's contract, fluidsim_tpu/engine.py)."""
    snap = str(tmp_path / "crash.npz")
    _, t_cfg = both("preset_smoke_box_32")
    eng = Engine(t_cfg, "cpu", nan_guard=True, crash_snapshot_path=snap)
    eng.step(2)
    good = eng.state
    eng.state = eng.state.replace(density=torch.full_like(eng.state.density, float("nan")))
    with pytest.raises(FloatingPointError, match="last good state saved"):
        eng.step(1)
    resumed = Engine.from_checkpoint(snap, "cpu")
    assert resumed._host_step == int(resumed.state.step) == 2
    for k in FIELDS:
        assert torch.equal(getattr(resumed.state, k), getattr(good, k)), k
    resumed.step(1)
    assert int(resumed.state.step) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_metrics_like_jax(dtype):
    _, t_cfg = both("preset_smoke_box_32", dtype=dtype)
    arrays = seeded_arrays(t_cfg)
    ref = j_metrics(*(jnp.asarray(arrays[k], jnp.bfloat16 if dtype == "bfloat16"
                                  else jnp.float32) for k in ("density", "velocity")))
    state = state_from_numpy(arrays, "cpu", dtype=dtype)
    got = compute_metrics(state.density, state.velocity)
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    for g, r in zip(got, ref):
        assert g.shape == ()
        np.testing.assert_allclose(float(g), float(r), rtol=rtol)


# -- interaction ------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
def test_point_injectors_like_jax(ndim):
    """add_density / add_velocity at in-range and clamped coordinates."""
    n = 24
    rng = np.random.default_rng(3)
    dens = rng.standard_normal((n,) * ndim).astype(np.float32)
    vel = rng.standard_normal((ndim,) + (n,) * ndim).astype(np.float32)
    for coords in ((3.7, 5.2, 9.9)[:ndim], (-4.0, 30.5, 2.0)[:ndim]):
        z = coords[2] if ndim == 3 else None
        amounts = (1.5, -2.0, 0.25)[:ndim]
        got = t_sources.add_density(torch.from_numpy(dens), coords[0], coords[1], 7.5, z=z)
        ref = j_sources.add_density(jnp.asarray(dens), coords[0], coords[1], 7.5, z=z)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        got = t_sources.add_velocity(torch.from_numpy(vel), coords[0], coords[1], amounts,
                                     z=z)
        ref = j_sources.add_velocity(jnp.asarray(vel), coords[0], coords[1], amounts, z=z)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def assert_close(got, ref, rtol, atol_rel, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("ndim", [2, 3])
def test_drag_force_like_jax(ndim):
    """mouse_drag_force, screen_to_grid and add_force_to_area on seeded
    fields (2D in the per-op class, 3D in the step class)."""
    name = "preset_scene_a" if ndim == 2 else "preset_smoke_box_32"
    j_cfg, t_cfg = both(name)
    prev, cur = (10.0, 12.0, 9.0)[:ndim], (16.5, 13.0, 11.0)[:ndim]
    assert t_interact.mouse_drag_force(prev, cur, t_cfg) == \
        j_interact.mouse_drag_force(prev, cur, j_cfg)
    assert t_interact.mouse_drag_force(cur, cur, t_cfg) == \
        j_interact.mouse_drag_force(cur, cur, j_cfg)
    assert t_interact.screen_to_grid((3.0, 4.5), (1.0, 2.0), (7.0, 9.0), 64) == \
        j_interact.screen_to_grid((3.0, 4.5), (1.0, 2.0), (7.0, 9.0), 64)
    center, force, radius = t_interact.mouse_drag_force(prev, cur, t_cfg)
    arrays = seeded_arrays(t_cfg)
    got = t_interact.add_force_to_area(torch.from_numpy(arrays["velocity"]),
                                       torch.from_numpy(arrays["density"]), center, force,
                                       radius, t_cfg.source_strength)
    ref = j_interact.add_force_to_area(jnp.asarray(arrays["velocity"]),
                                       jnp.asarray(arrays["density"]), center, force, radius,
                                       j_cfg.source_strength)
    rtol, atol = (2e-6, 1e-6) if ndim == 2 else (1e-5, 1e-6)
    for what, g, r in zip(("velocity", "density"), got, ref):
        assert_close(g.numpy(), r, rtol, atol, what)
        assert not np.array_equal(np.asarray(r), arrays[what])


@pytest.mark.parametrize("name", ["preset_scene_a", "preset_smoke_box_32"])
def test_engine_drag_like_jax(name):
    """``Engine.drag`` on each package's engine from the same state (2D
    scene_a at 192², 3D smoke32): the 2D per-op class, the 3D step class."""
    j_cfg, t_cfg = both(name)
    arrays = seeded_arrays(t_cfg)
    arrays["obstacles"] = np.zeros_like(arrays["obstacles"])
    j_eng, t_eng = JEngine(j_cfg), Engine(t_cfg, "cpu")
    j_eng.state = jax_state(arrays, "float32")
    t_eng.state = state_from_numpy(arrays, "cpu")
    n = t_cfg.current_size
    prev = tuple(n * f for f in (0.2, 0.3, 0.5)[:t_cfg.ndim])
    cur = tuple(n * f for f in (0.3, 0.28, 0.55)[:t_cfg.ndim])
    j_eng.drag(prev, cur)
    t_eng.drag(prev, cur)
    rtol, atol = (2e-6, 1e-6) if t_cfg.ndim == 2 else (1e-5, 1e-6)
    for k in ("velocity", "density"):
        assert_close(getattr(t_eng.state, k).numpy(), getattr(j_eng.state, k), rtol, atol, k)
        assert not np.array_equal(getattr(t_eng.state, k).numpy(), arrays[k])


# -- 2D frames ----------------------------------------------------------------------


def frame_inputs(n=48):
    rng = np.random.default_rng(11)
    density = (np.abs(rng.standard_normal((n, n))) * 80).astype(np.float32)
    pressure = (rng.standard_normal((n, n)) * 40).astype(np.float32)
    obst = np.zeros((n, n), bool)
    obst[10:14, 10:16] = True
    return density, pressure, obst


@pytest.mark.parametrize("change", [dict(color_mode=m) for m in ColorMode] + [
    dict(use_lerp=True), dict(enable_custom_source=True, visualize_source_position=True),
    dict(colour_intensity=0.01, color_mode=ColorMode.GRADIENT)],
    ids=[m.name for m in ColorMode] + ["lerp", "marker", "gradient-dim"])
def test_render_frame_2d_like_jax(change):
    j_cfg, t_cfg = both("preset_scene_b", size=48, **change)
    density, pressure, obst = frame_inputs()
    got = t_cmap.render_frame_2d(torch.from_numpy(density), torch.from_numpy(pressure),
                                 torch.from_numpy(obst), t_cfg, elapsed_time=13.7)
    ref = j_cmap.render_frame_2d(jnp.asarray(density), jnp.asarray(pressure),
                                 jnp.asarray(obst), j_cfg, elapsed_time=13.7)
    assert got.shape == (48, 48, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_evaluate_gradient_like_jax():
    t = np.linspace(-0.2, 1.2, 97).astype(np.float32)
    cfg = t_config.preset_scene_b()
    for k in (0, 1, 2, len(cfg.gradient_times)):
        colors, times = cfg.gradient_colors[:k], cfg.gradient_times[:k]
        got = t_cmap.evaluate_gradient(torch.from_numpy(t), colors, times)
        ref = j_cmap.evaluate_gradient(jnp.asarray(t), jnp.asarray(colors, jnp.float32)
                                       .reshape(k, 4), jnp.asarray(times, jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_streamlines_like_jax():
    """Segments on the device (rtol 1e-6), then the same host rasterizer on
    the same segments: equal overlays and composites; the NumPy fallback
    equals the native rasterizer where that loads."""
    j_cfg, t_cfg = both("preset_scene_b", size=64, streamline_density=1,
                        streamline_scale=3.0, streamline_thickness=2.0)
    assert t_cfg.current_size == 64
    rng = np.random.default_rng(5)
    vx, vy = (rng.standard_normal((2, 64, 64)) * 0.8).astype(np.float32)
    obst = rng.random((64, 64)) < 0.1
    got = t_stream.compute_streamline_segments(torch.from_numpy(vx), torch.from_numpy(vy),
                                               torch.from_numpy(obst), t_cfg)
    ref = np.asarray(j_stream.compute_streamline_segments(jnp.asarray(vx), jnp.asarray(vy),
                                                          jnp.asarray(obst), j_cfg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert (got[:, 0] < 0).any() and (got[:, 0] >= 0).any()
    base = np.random.default_rng(6).random((64, 64, 4)).astype(np.float32)
    for frame in (None, base):
        mine = t_stream.rasterize_streamlines(got, t_cfg, base_frame=frame)
        theirs = j_stream.rasterize_streamlines(got.numpy(), j_cfg, base_frame=None
                                                if frame is None else frame.copy())
        np.testing.assert_array_equal(mine, theirs)
    assert t_stream.native_rasterizer_available() == j_stream.native_rasterizer_available()
    ref_np = np.zeros((64, 64, 4), np.float32)
    t_stream._rasterize_numpy(got.numpy(), ref_np, np.asarray(t_cfg.streamline_color,
                                                              np.float32), 64, 2.0)
    np.testing.assert_array_equal(t_stream.rasterize_streamlines(got, t_cfg), ref_np)


def test_export_html_is_the_jax_package_file(tmp_path):
    rng = np.random.default_rng(9)
    frames = [rng.random((24, 24, 4)).astype(np.float32),
              rng.random((24, 24, 3)).astype(np.float32) * 1.3 - 0.1]
    frames = [f[..., :3] for f in frames]
    a = export_html(frames, str(tmp_path / "t" / "index.html"), title="t", fps=12)
    b = j_export_html(frames, str(tmp_path / "j" / "index.html"), title="t", fps=12)
    assert open(a, "rb").read() == open(b, "rb").read()


# -- the live viewer --------------------------------------------------------------------


def live_cfg():
    return SimConfig(size=32, time_step=0.05, enable_custom_source=True,
                     source_strength=60.0, source_radius=2.0, source_position=(0.3, 0.5),
                     enable_obstacle=False, obstacle_position=(0.5, 0.5), jacobi_iters=4,
                     double_diffuse=False)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def test_live_server_on_the_cpu(tmp_path):
    """tests/test_live.py's sequence on the port's server over a CPU engine:
    the page, frames, a drag that stirs, shift-drag, pause, save (a JSON
    config without a store, a SimulationRuns row with one), and quit."""
    out = str(tmp_path / "cfg.json")
    srv = LiveServer(Engine(live_cfg(), "cpu"), port=0, steps_per_frame=1, poll_ms=30,
                     config_out=out)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, page = _get(base + "/")
        assert status == 200 and b"canvas" in page and b'id="menu"' in page
        t0 = time.time()
        while int(srv.engine.state.step) < 3 and time.time() - t0 < 30:
            time.sleep(0.05)
        assert int(srv.engine.state.step) >= 3
        status, png = _get(base + "/frame.png")
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        assert _post(base + "/event", {"type": "pause", "paused": True}) == 200
        time.sleep(0.2)
        v_before = float(srv.engine.state.velocity.abs().max())
        assert _post(base + "/event", {"type": "drag", "prev": [8, 16], "cur": [14, 16]}) == 200
        assert float(srv.engine.state.velocity.abs().max()) > v_before
        s1 = int(srv.engine.state.step)
        time.sleep(0.3)
        assert int(srv.engine.state.step) == s1
        assert _post(base + "/event", {"type": "source", "pos": [16.0, 24.0]}) == 200
        assert srv.engine.get_source_position() == (16.0, 24.0)
        assert _post(base + "/event", {"type": "save"}) == 200
        assert t_ckpt.load_config(out).size == 32
        with pytest.raises(urllib.error.HTTPError):
            _post(base + "/event", {"type": "drag"})
        assert _post(base + "/event", {"type": "quit"}) == 200
        t0 = time.time()
        while srv._running and time.time() - t0 < 10:
            time.sleep(0.05)
        assert not srv._running
        srv._sim_thread.join(timeout=10)
        assert not srv._sim_thread.is_alive()
    finally:
        srv.stop()
    with MetricsStore(str(tmp_path / "m.db")) as store:
        srv = LiveServer(Engine(live_cfg(), "cpu", store=store), port=0, steps_per_frame=1)
        srv.start()
        try:
            assert _post(f"http://127.0.0.1:{srv.port}/event", {"type": "save"}) == 200
            runs = store._conn.execute("SELECT COUNT(*) FROM SimulationRuns").fetchone()[0]
            assert runs == 2  # the engine's row and the saved one
        finally:
            srv.stop()
