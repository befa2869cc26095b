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


def test_bench_mesh_on_the_cpu(capsys):
    assert main(MESH_BENCH + ["--device", "cpu"]) == 0
    port = last_json(capsys)
    j_main(MESH_BENCH)
    ref = last_json(capsys)
    assert set(port) == set(ref) | {"devices"}
    assert port["devices"] == 1 and port["platform"] == "cpu"
    assert port["mesh"] == 2 and port["grid"] == [16, 16, 16]
    assert port["halo"] == "explicit" and port["halo_block_iters"] == 2
    assert port["count"] == 2 and port["steps_per_sec"] > 0


def test_bench_engine_on_the_cpu(capsys):
    assert main(["bench", "--device", "cpu", "--preset", "smoke32", "--steps", "2",
                 "--substeps", "1"]) == 0
    res = last_json(capsys)
    assert res["grid"] == [32, 32, 32] and res["count"] == 2 and res["p50_ms"] > 0
