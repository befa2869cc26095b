"""The command line of fluidsim_tpu_torch (``cli.py``) against the JAX
package's, on the CPU (``--device cpu``): ``presets``; ``bench --mesh``,
whose JSON line carries the JAX package's keys (``fluidsim_tpu/cli.py``'s
``_bench_sharded``) plus ``devices``; ``save-config`` (the same file and
store row); ``run`` with ``--db`` and ``--checkpoint`` (the same metric
rows, and a checkpoint each package loads, in smoke32's 3-step class of
tests/test_torch_plume.py: rtol 1e-5, atol 1e-5·max|ref|); ``run --config``
at ``advect_window`` 4 resumed from its checkpoint, bitwise a continuous
run; ``render`` (3D, and 2D with streamlines, ``--html``); and the refusal
to step without a card unless ``--device cpu`` is given."""

import collections
import json
import sqlite3

import numpy as np
import pytest
import torch

from fluidsim_tpu.cli import main as j_main
from fluidsim_tpu.io.checkpoint import load_checkpoint as j_load_checkpoint

from fluidsim_tpu_torch.cli import main
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.checkpoint import load_checkpoint, load_config, save_config
from fluidsim_tpu_torch.io.convert import state_to_numpy

MESH_BENCH = ["bench", "--preset", "sharded512", "--size", "16", "--mesh", "2", "--halo",
              "explicit", "--halo-block-iters", "2", "--steps", "2", "--substeps", "1"]


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_presets(capsys):
    main(["presets"])
    port = capsys.readouterr().out.splitlines()
    j_main(["presets"])
    assert port == capsys.readouterr().out.splitlines()
    assert any(line.startswith("sharded512") for line in port)


def test_bench_mesh_on_the_cpu(capsys, monkeypatch):
    assert main(MESH_BENCH + ["--device", "cpu"]) == 0
    port = last_json(capsys)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)  # see the rdma case below
    j_main(MESH_BENCH)
    ref = last_json(capsys)
    assert set(port) == set(ref) | {"devices"}
    assert port["devices"] == 1 and port["platform"] == "cpu"
    assert port["mesh"] == 2 and port["grid"] == [16, 16, 16]
    assert port["halo"] == "explicit" and port["halo_block_iters"] == 2
    assert port["count"] == 2 and port["steps_per_sec"] > 0


def test_bench_mesh_rdma_on_the_cpu(capsys, monkeypatch):
    """``--halo-backend rdma`` (K12/K13's twins on the CPU), float32 and
    bfloat16, against the JAX package's keys.  Without ``JAX_PLATFORMS`` in
    the environment the JAX command leaves the host device count alone
    (with it, it sets ``jax_num_cpu_devices`` to ``--mesh``, and the tests
    that follow in the process see that many devices)."""
    rdma = ["--halo-backend", "rdma", "--device", "cpu"]
    assert main(MESH_BENCH + rdma) == 0
    port = last_json(capsys)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    j_main(MESH_BENCH + ["--halo-backend", "rdma", "--pallas-interpret"])
    ref = last_json(capsys)
    assert set(port) == set(ref) | {"devices"}
    assert port["halo_backend"] == "rdma" and port["mesh"] == 2
    assert port["count"] == 2 and port["steps_per_sec"] > 0
    assert main(MESH_BENCH + rdma + ["--dtype", "bfloat16"]) == 0
    assert last_json(capsys)["steps_per_sec"] > 0


def test_bench_engine_on_the_cpu(capsys):
    assert main(["bench", "--device", "cpu", "--preset", "smoke32", "--steps", "2",
                 "--substeps", "1"]) == 0
    res = last_json(capsys)
    assert res["grid"] == [32, 32, 32] and res["count"] == 2 and res["p50_ms"] > 0


def test_bench_profile_writes_the_programs_spans(capsys, tmp_path):
    """``bench --profile DIR`` writes a Chrome trace in which the program's
    spans (``tracing()`` is on inside it) sit beside the operations."""
    out = tmp_path / "prof"
    assert main(["bench", "--device", "cpu", "--preset", "smoke32", "--steps", "2",
                 "--substeps", "1", "--profile", str(out)]) == 0
    assert last_json(capsys)["profile"] == str(out)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = collections.Counter(e.get("name") for e in events)
    assert names["engine.step"] == 2
    assert names["phase.project"] == 2 and names["engine.source"] == 2


def test_save_config_like_jax(tmp_path, capsys):
    outs = {}
    for who, fn in (("port", main), ("jax", j_main)):
        out, db = str(tmp_path / f"{who}.json"), str(tmp_path / f"{who}.db")
        fn(["save-config", "--preset", "plume64", "-o", out, "--db", db])
        outs[who] = last_json(capsys)
        outs[who]["out"] = None
    assert outs["port"] == outs["jax"] and outs["port"]["run_id"] == 1
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def metric_rows(db):
    with sqlite3.connect(db) as conn:
        return conn.execute("SELECT RunID, Step, AverageDensity, MaxVelocityMagnitude "
                            "FROM RuntimeMetrics ORDER BY MetricID").fetchall()


def test_run_with_db_and_checkpoint_like_jax(tmp_path, capsys):
    """smoke32 for 3 steps, with the metrics interval cut to 1 step through a
    config file: the store's rows and the checkpoints of both packages, in
    smoke32's 3-step class (tests/test_torch_plume.py: rtol 1e-5, atol
    1e-5·max|ref|; a sensitive scene)."""
    cfg = str(tmp_path / "cfg.json")
    main(["save-config", "--preset", "smoke32", "-o", cfg])
    capsys.readouterr()
    save_config(cfg, load_config(cfg).replace(logging_interval=1))
    res = {}
    for who, fn, extra in (("port", main, ["--device", "cpu"]), ("jax", j_main, [])):
        args = ["run", "--config", cfg, "--steps", "3", "--substeps", "1",
                "--db", str(tmp_path / f"{who}.db"),
                "--checkpoint", str(tmp_path / f"{who}.npz")] + extra
        assert fn(args) in (0, None)
        res[who] = last_json(capsys)
    assert set(res["port"]) == set(res["jax"])
    for key in ("preset", "grid", "steps", "run_id", "count"):
        assert res["port"][key] == res["jax"][key], key
    assert res["port"]["steps"] == 3 and res["port"]["steps_per_sec"] > 0
    rows = {who: metric_rows(str(tmp_path / f"{who}.db")) for who in res}
    assert [r[:2] for r in rows["port"]] == [r[:2] for r in rows["jax"]] == [(1, 1), (1, 2), (1, 3)]
    got, ref = (np.asarray([r[2:] for r in rows[who]]) for who in ("port", "jax"))
    for c in range(ref.shape[1]):
        np.testing.assert_allclose(got[:, c], ref[:, c], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref[:, c]).max()))
    state, _ = load_checkpoint(str(tmp_path / "port.npz"), "cpu")
    j_state, _ = j_load_checkpoint(str(tmp_path / "jax.npz"))
    jax_in_port = load_checkpoint(str(tmp_path / "jax.npz"), "cpu")[0]
    ours = state_to_numpy(state)
    for k in ("density", "velocity", "pressure"):
        ref = np.asarray(getattr(j_state, k))
        np.testing.assert_array_equal(getattr(jax_in_port, k).numpy(), ref)
        np.testing.assert_allclose(ours[k], ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=k)
    assert int(state.step) == int(j_state.step) == 3


def test_run_at_window_4_resumes_bitwise(tmp_path, capsys):
    """The user's way to a window of 4 cells: ``save-config``, edit
    ``advect_window``, ``run --config``; then ``Engine.from_checkpoint``
    and more steps equal a continuous run bitwise (plume64 cut to 32³)."""
    cfg_path = str(tmp_path / "cfg.json")
    main(["save-config", "--preset", "plume64", "-o", cfg_path])
    d = json.loads(open(cfg_path).read())
    d["advect_window"] = 4
    open(cfg_path, "w").write(json.dumps(d, indent=2))
    ckpt = str(tmp_path / "s.npz")
    assert main(["run", "--config", cfg_path, "--size", "32", "--device", "cpu",
                 "--steps", "3", "--substeps", "3", "--checkpoint", ckpt]) == 0
    assert last_json(capsys)["steps"] == 3
    resumed = Engine.from_checkpoint(ckpt, "cpu")
    assert resumed.cfg.advect_window == 4 and resumed.cfg.size == 32
    resumed.step(2)
    whole = Engine(resumed.cfg, "cpu")
    whole.step(5)
    for k in ("density", "velocity", "pressure", "step", "time"):
        assert torch.equal(getattr(resumed.state, k), getattr(whole.state, k)), k


@pytest.mark.parametrize("case", ["3d", "2d-streamlines"])
def test_render_like_jax(tmp_path, capsys, case):
    if case == "3d":
        args = ["render", "--preset", "smoke32", "--steps", "4", "--render-every", "2"]
    else:
        cfg = str(tmp_path / "cfg.json")
        main(["save-config", "--preset", "scene_b", "-o", cfg])
        capsys.readouterr()
        save_config(cfg, load_config(cfg).replace(
            size=32, show_streamlines=True, streamline_density=1, source_emits_velocity=True,
            source_velocity=10.0))
        args = ["render", "--config", cfg, "--steps", "4", "--render-every", "2"]
    res = {}
    for who, fn, extra in (("port", main, ["--device", "cpu"]), ("jax", j_main, [])):
        out = tmp_path / who
        assert fn(args + ["-o", str(out), "--html"] + extra) in (0, None)
        res[who] = last_json(capsys)
        assert sorted(p.name for p in out.iterdir()) == [
            "frame_00000.png", "frame_00001.png", "index.html"]
        res[who]["outdir"] = res[who]["html"] = None
    assert res["port"] == res["jax"]


def test_stepping_commands_need_the_card(capsys):
    """Without ``--device cpu`` every stepping command asks for the card and,
    without one, fails: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the commands would step on it")
    for cmd in (["run"], ["render"], ["serve"], ["bench"]):
        assert main(cmd + ["--preset", "smoke32"]) == 1
        assert "no CUDA device" in last_json(capsys)["error"]
