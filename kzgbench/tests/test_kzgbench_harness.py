"""The harness as a whole on the CPU: BENCHMARK.json keeps the contract's
static rules, every name resolves to its files, a run without a card exits
non-zero and prints no result, and nothing of JAX or of the JAX package is
loaded by the harness, nor anything of the program by the reference."""

import json
import os
import re
import subprocess
import sys

import pytest

from kzgbench import byname, callkind

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_static_rules():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["kzgbench"] and 1 <= b["run_seconds"] <= 51
    assert all(os.path.isfile(os.path.join(ROOT, w)) for w in b["command"][1:2])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert {"latency_ms", "latency_p90_ms", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and m["moves"] in e2e
    cells = {w["name"] for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("kzgbench/")
        assert c["reduced"] == [] and len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in b["workloads"])
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert all(set(m.get("workloads", cells)) <= cells for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_resolves():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "kzgbench", "metrics", m["name"] + ".py"))
    for w in b["workloads"]:
        for sub in ("traffic", "work"):
            assert os.path.isfile(os.path.join(ROOT, "kzgbench", sub, w["traffic"] + ".json"))
        with open(os.path.join(ROOT, "kzgbench", "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert callkind.kind(traffic, ROOT).checks
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_no_card_exits_nonzero_without_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "kzgbench/run.py", "--workload", "cells-verify-column", "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"metrics"' not in out.stdout and "needs 1 CUDA device" in out.stderr


@pytest.mark.parametrize(
    "module, absent",
    [
        ("kzgbench.harness", ("jax", "jaxlib", "flax", "kzg_tpu")),
        ("kzgbench.reference.kzg", ("jax", "kzg_tpu", "kzg_tpu_torch", "torch")),
        ("kzgbench.reference.pool", ("jax", "kzg_tpu", "kzg_tpu_torch", "torch")),
    ],
)
def test_imports(module, absent):
    code = (
        f"import sys, importlib; importlib.import_module({module!r}); "
        "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    loaded = set(out.stdout.strip().split(","))
    assert not loaded & set(absent)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from kzgbench import harness

    monkeypatch.setitem(sys.modules, "kzg_tpu_torch_lookalike", sys)
    assert "kzg_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kzg_tpu.oracle", sys)
    assert "kzg_tpu" in harness.forbidden_modules()


def test_byname_loads_once_and_keeps_names_apart():
    a = byname.load("metrics", "device.idle_pct")
    assert byname.load("metrics", "device.idle_pct") is a
    assert byname.load("metrics", "latency_ms") is not a
    with pytest.raises(ValueError, match="no calls named"):
        byname.load("calls", "no_such_call")
