"""The command line of fluidsim_tpu_torch (``cli.py``): ``presets``, and
``bench --mesh`` on the CPU, whose JSON line carries the JAX package's keys
(``fluidsim_tpu/cli.py``'s ``_bench_sharded``) plus ``devices``."""

import json

from fluidsim_tpu.cli import main as j_main

from fluidsim_tpu_torch.cli import main

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
