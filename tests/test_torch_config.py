"""fluidsim_tpu_torch: the configuration copy, obstacle rasterization and
the package's independence from JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fluidsim_tpu.config as jcfg
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask

import fluidsim_tpu_torch.config as tcfg
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

torch.set_num_threads(1)


def test_preset_names_match():
    assert list(tcfg.PRESETS) == list(jcfg.PRESETS)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_equals_jax_field_for_field(name):
    ref = jcfg.PRESETS[name]()
    got = tcfg.PRESETS[name]()
    ref_fields = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(got)] == ref_fields
    for field in ref_fields:
        a, b = getattr(got, field), getattr(ref, field)
        if isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            # extra_sources: SourceSpec tuples from the two packages
            assert [dataclasses.asdict(s) for s in a] == [
                dataclasses.asdict(s) for s in b], field
        else:
            assert a == b, field
            assert type(a).__name__ == type(b).__name__, field
    assert got.effective_params() == ref.effective_params()
    assert got.grid_shape == ref.grid_shape
    assert got.cell_size == ref.cell_size


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_obstacle_mask_equals_jax(name, forced):
    """The preset's mask as shipped, and with its obstacle switched on so
    every preset's geometry is rasterized.  Grids above 128³ are cut to 64³
    to keep the test fast; the rasterization does not depend on size."""

    def cut(cfg):
        if cfg.ndim == 3 and cfg.current_size > 128:
            cfg = cfg.replace(size=64)
        return cfg.replace(enable_obstacle=True) if forced else cfg

    ref = j_build_mask(cut(jcfg.PRESETS[name]()))
    got = build_obstacle_mask(cut(tcfg.PRESETS[name]()))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_import_leaves_jax_out():
    code = (
        "import sys, fluidsim_tpu_torch, fluidsim_tpu_torch.engine, "
        "fluidsim_tpu_torch.io.convert, fluidsim_tpu_torch.render.raymarch, "
        "fluidsim_tpu_torch.kernels._build, fluidsim_tpu_torch.models.stable2d, "
        "fluidsim_tpu_torch.kernels.resident2d, fluidsim_tpu_torch.models.step_kernels, "
        "fluidsim_tpu_torch.ops.fft_poisson, fluidsim_tpu_torch.dtypes, "
        "fluidsim_tpu_torch.kernels.jacobi, fluidsim_tpu_torch.kernels.resident\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fluidsim_tpu' or m.startswith('fluidsim_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
