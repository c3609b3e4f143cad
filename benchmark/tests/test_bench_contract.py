"""``BENCHMARK.json`` against the benchmark's contract (names, units, keys,
files), the import rule, and the harness finding new cells, traffic and
metrics as files of their own."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, make_root

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def metric_names():
    return [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]


def test_keys_and_limits():
    b = BENCHMARK
    assert set(b) == KEYS["top"]
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    for c in b["configs"]:
        assert set(c) == KEYS["config"]
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("field", ["name", "config", "traffic", "reduced", "unit", "text"])
def test_names_and_units(field):
    b = BENCHMARK
    if field == "name":
        names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
                 for x in b[g]]
        assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    elif field in ("config", "traffic"):
        assert all(NAME.match(w[field]) for w in b["workloads"])
    elif field == "reduced":
        assert all(NAME.match(k) for c in b["configs"] for k in c["reduced"])
    elif field == "unit":
        assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
                   for m in b["end_to_end"] + b["per_layer"])
    else:
        texts = [x["why"] for x in b["workloads"] + b["configs"]] \
            + [m["layer"] for m in b["per_layer"]] \
            + [c["source"] for c in b["configs"]] + b["command"]
        assert all(TEXT.match(t) for t in texts)
        assert all(re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) for p in b["paths"])


def test_every_cell_reports_what_its_metrics_move():
    b = BENCHMARK
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert all(e2e["setup_s"] == set(cells) for _ in [0])
    for c in cells:
        assert sum(c in s for k, s in e2e.items() if k != "setup_s") >= 1
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
    layers = {m["layer"] for m in b["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    assert all(layer in perf for layer in layers)


def test_every_name_has_its_files():
    b = BENCHMARK
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "workloads", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
    for n in metric_names():
        assert os.path.exists(os.path.join(BENCH, "metrics", n + ".py")), n


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    """Compared by whole top-level names: ``hd_yolo_tpu_torch`` is the port
    (allowed outside the reference), ``hd_yolo_tpu`` the JAX package."""
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        mods = set(_top_imports(path))
        assert not mods & {"jax", "jaxlib", "flax", "hd_yolo_tpu"}, path
        if os.sep + "reference" + os.sep in path:
            assert "hd_yolo_tpu_torch" not in mods, path
    for path in glob.glob(os.path.join(BENCH, "spans", "*.json")):
        for t in json.load(open(path))["targets"]:
            assert t["module"].split(".")[0] == "hd_yolo_tpu_torch"


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness; "
            "harness.run_cell(%r, 'tiny-tiles', 3, 0.5, True, device='cpu'); "
            "print(harness.forbidden_modules())" % (BENCH, ROOT, tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_new_files_are_found_without_editing_any(tmp_path):
    """A configuration, a traffic mix and a metric added as new files (and
    entries in ``BENCHMARK.json``) run without a change to any file."""
    import harness

    root = make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "metrics", "served_per_tile.tiles.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['items'] * 1.0\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "served_per_tile.tiles", "unit": "tiles", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "p95_ms",
                               "workloads": ["tiny-tiles"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    res = harness.run_cell(root, "tiny-tiles", 11, 0.5, True, device="cpu")
    assert res["metrics"]["served_per_tile.tiles"]["value"] == 2.0
    assert list(res)[-2:] == ["checks", "_log"]
