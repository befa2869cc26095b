"""The sharded checkpoint of fluidsim_tpu_torch (``io/checkpoint.
save_checkpoint_sharded`` and ``load_checkpoint_sharded``), the counterpart
of the JAX package's orbax pair, and the port's imports.

A state saved with the JAX ``save_checkpoint_orbax`` and restored with its
``load_checkpoint_orbax`` (vortex128 cut to 32³: its sphere; float32 and
bfloat16 fields) goes through ``io/convert`` into the port, is saved on 4
shards and loaded on 4, on 2 and unsharded: every load bitwise the
JAX-restored arrays (bfloat16 compared as bits), with step, time and config
equal.  One ``.npy`` a field a slab; no module of the port imports ``orbax``
or ``jax``.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.config as j_config
from fluidsim_tpu.io.checkpoint import config_to_json as j_config_to_json
from fluidsim_tpu.io.checkpoint import load_checkpoint_orbax, save_checkpoint_orbax
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_mask
from fluidsim_tpu.state import FluidState as JState

from fluidsim_tpu_torch.io.checkpoint import (
    config_from_json,
    load_checkpoint_sharded,
    save_checkpoint_sharded,
)
from fluidsim_tpu_torch.io.convert import state_from_numpy
from fluidsim_tpu_torch.parallel import ShardedState, make_mesh, shard_state, unshard_state

N = 32
ALL = ("density", "velocity", "pressure", "obstacles", "step", "time")
PORT = Path(__file__).resolve().parents[1] / "fluidsim_tpu_torch"


def bits(t):
    """A tensor's storage as comparable integers (bfloat16 by its bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def restored(request, tmp_path_factory):
    """The JAX orbax pair's round trip of a seeded vortex128 state at 32³:
    ``(arrays, port state, port config)``, the arrays as JAX restored them."""
    dtype = request.param
    jcfg = j_config.preset_vortex_128().replace(size=N, dtype=dtype)
    rng = np.random.default_rng(21)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    state = JState(
        density=jnp.asarray(rng.random((N, N, N), np.float32) * 5, jdt),
        velocity=jnp.asarray(rng.standard_normal((3, N, N, N)).astype(np.float32), jdt),
        pressure=jnp.asarray(rng.standard_normal((N, N, N)).astype(np.float32), jdt),
        obstacles=jnp.asarray(j_mask(jcfg)),
        step=jnp.asarray(17, jnp.int32),
        time=jnp.asarray(0.4321, jnp.float32))
    path = str(tmp_path_factory.mktemp("orbax") / f"snap_{dtype}")
    save_checkpoint_orbax(path, state, jcfg)
    back, back_cfg = load_checkpoint_orbax(path)
    arrays = {f: np.asarray(getattr(back, f)) for f in ALL}
    cfg = config_from_json(j_config_to_json(back_cfg))
    return arrays, state_from_numpy(arrays, "cpu", dtype=cfg.dtype), cfg


def same_as_jax(state, arrays):
    for f in ALL:
        got, want = bits(getattr(state, f)), jax_bits(arrays[f])
        assert got.dtype == want.dtype and np.array_equal(got, want), f


def test_the_jax_state_converts_bitwise(restored):
    arrays, state, cfg = restored
    same_as_jax(state, arrays)
    assert state.density.dtype == getattr(torch, cfg.dtype)


@pytest.mark.parametrize("shards", [4, 2, None], ids=["4", "2", "unsharded"])
def test_saved_on_4_loads_bitwise(restored, tmp_path, shards):
    """Saved from 4 shards, loaded on 4, on 2 or unsharded: bitwise the JAX
    restored arrays, each shard's slab and its mask's halo as
    ``shard_state`` places them, step, time and config equal."""
    arrays, state, cfg = restored
    path = str(tmp_path / "ck")
    save_checkpoint_sharded(path, shard_state(state, make_mesh(["cpu"] * 4)), cfg)
    mesh = None if shards is None else make_mesh(["cpu"] * shards)
    got, got_cfg = load_checkpoint_sharded(path, mesh, device="cpu")
    assert got_cfg == cfg
    if mesh is not None:
        assert isinstance(got, ShardedState) and len(got.slabs) == shards
        want = shard_state(state, mesh)
        for slab, ref in zip(got.slabs, want.slabs):
            assert (slab.rank, slab.z0) == (ref.rank, ref.z0)
            for f in ALL:
                assert np.array_equal(bits(getattr(slab, f)), bits(getattr(ref, f))), f
        got = unshard_state(got)
    same_as_jax(got, arrays)


def test_one_file_a_field_a_slab(restored, tmp_path):
    """Four slabs: four files for each field, step, time and the index, the
    config beside the directory; saving again on 2 replaces the 4-slab
    files; an unsharded state is one slab."""
    _, state, cfg = restored
    path = str(tmp_path / "ck")
    save_checkpoint_sharded(path, shard_state(state, make_mesh(["cpu"] * 4)), cfg)
    fields = ("density", "velocity", "pressure", "obstacles")
    want = {f"{f}.{r}.npy" for f in fields for r in range(4)}
    assert set(os.listdir(path)) == want | {"step.npy", "time.npy", "index.json"}
    assert os.path.exists(path + ".config.json")
    for r in range(4):
        assert np.load(os.path.join(path, f"velocity.{r}.npy")).shape == (3, N // 4, N, N)
    save_checkpoint_sharded(path, shard_state(state, make_mesh(["cpu"] * 2)), cfg)
    assert set(os.listdir(path)) == ({f"{f}.{r}.npy" for f in fields for r in range(2)}
                                     | {"step.npy", "time.npy", "index.json"})
    save_checkpoint_sharded(path, state, cfg)
    got, _ = load_checkpoint_sharded(path, device="cpu")
    for f in ALL:
        assert np.array_equal(bits(getattr(got, f)), bits(getattr(state, f))), f


def test_load_refuses_a_mesh_that_does_not_divide(restored, tmp_path):
    _, state, cfg = restored
    path = str(tmp_path / "ck")
    save_checkpoint_sharded(path, state, cfg)
    with pytest.raises(ValueError, match="divisible"):
        load_checkpoint_sharded(path, make_mesh(["cpu"] * 3))


def test_the_port_imports_neither_orbax_nor_jax():
    """No module of ``fluidsim_tpu_torch/`` imports ``orbax``, ``jax`` or the
    JAX package, at any level of the module."""
    banned = ("orbax", "jax", "jaxlib", "fluidsim_tpu")
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    found.append(f"{path.relative_to(PORT.parent)}: {name}")
    assert len(list(PORT.rglob("*.py"))) > 40
    assert found == []
