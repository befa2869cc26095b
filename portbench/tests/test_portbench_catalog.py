"""The benchmark's files on their own: ``BENCHMARK.json``'s names and units,
the files each name leads to, the imports of every module under
``portbench/``, and the bounds of ``roofline.py`` against the kernel table of
``PERF.md``."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from portbench import roofline

HERE = Path(__file__).resolve().parent.parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FORBIDDEN = {"jax", "jaxlib", "flax", "fluidsim_tpu"}


def all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_every_name_keeps_the_character_rule(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_unit_and_a_reader(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files(w):
    cell = json.loads((HERE / "cells" / f"{w['name']}.json").read_text())
    assert cell["config"] == w["config"]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    assert (HERE / "drivers" / f"{cell['driver']}.py").is_file()
    assert (HERE / "reference" / f"{config['reference']}.py").is_file()
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    # Every cell reports set-up, another end-to-end metric and a per-layer one.
    e2e = {m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", []) for m in BENCH["per_layer"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_is_the_programs_preset(c):
    """The configuration files hold every setting of the program's preset
    that they name, unchanged (``reduced`` is empty)."""
    import dataclasses
    import enum

    from fluidsim_tpu_torch import config as program_config

    data = json.loads((HERE.parent / c["file"]).read_text())
    preset = getattr(program_config, data["program_preset"].rsplit(".", 1)[1])()

    def plain(v):
        if isinstance(v, enum.Enum):
            return int(v)
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    want = {f.name: plain(getattr(preset, f.name)) for f in dataclasses.fields(preset)}
    assert data["sim"] == want
    assert c["reduced"] == []


def test_run_seconds_fits_the_check_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert not top & FORBIDDEN, (path, top & FORBIDDEN)
    if "reference" in path.relative_to(HERE).parts:
        assert "fluidsim_tpu_torch" not in top, path
        assert "portbench" not in top, path


def test_the_run_names_a_loaded_jax_by_its_whole_top_level_name(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location("portbench_run", HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)

    monkeypatch.setitem(sys.modules, "fluidsim_tpu_torch_extra", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "fluidsim_tpu.config", sys)
    assert run.loaded_forbidden() == ["fluidsim_tpu", "jax"]


def test_roofline_reproduces_the_kernel_tables_bounds():
    """``PERF.md`` §6: K2 0.0225 ms at 128³ (60 sweeps), K12 0.0676 ms a
    shard's round at T = 4 on 8 shards of 512³, K6 0.4808 ms at 512³ (20
    sweeps); all three bound by bytes."""
    assert round(roofline.k2_ms(128, 60), 4) == 0.0225
    assert round(roofline.k12_round_ms(512, 64, 4), 4) == 0.0676
    assert round(roofline.k6_ms(512, 20), 4) == 0.4808
    n = 128
    assert roofline.k2_ms(n, 60) == 9 * n ** 3 * 4 / roofline.HBM_BYTES_PER_S * 1e3
