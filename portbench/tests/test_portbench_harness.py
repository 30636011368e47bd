"""The harness on the CPU: BENCHMARK.json's names and units, the files a
later change adds found by name, and a short render and training run
printing a last line of the contract's shape."""

import json
import pathlib
import re
import shutil

import pytest

from portbench import core
from portbench.tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = ("command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_only_the_allowed_characters():
    b = _bench()
    assert tuple(b) == TOP
    entries = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in b["configs"]]
                 + [e["why"] for e in b["configs"] + b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = core.load_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got and m["moves"] in e2e


def test_a_later_change_adds_a_config_traffic_and_metric_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "cornell.json").read_text())
    cfg["name"] = "cornell_wide"
    cfg["width"] = 1280
    (pb / "configs" / "cornell_wide.json").write_text(json.dumps(cfg))
    trf = json.loads((pb / "traffic" / "render.json").read_text())
    trf["spp"] = 4
    (pb / "traffic" / "preview.json").write_text(json.dumps(trf))
    (pb / "limits" / "cornell_wide.preview.json").write_text(
        (pb / "limits" / "cornell.render.json").read_text())
    (pb / "metrics" / "frames_traced.render.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="cornell_wide",
                             file="portbench/configs/cornell_wide.json"))
    b["workloads"].append({"name": "cornell_wide.preview",
                           "config": "cornell_wide", "traffic": "preview",
                           "chips": 1, "why": "a test cell"})
    for m in b["end_to_end"]:
        if "workloads" in m and "cornell.render" in m["workloads"]:
            m["workloads"].append("cornell_wide.preview")
    b["per_layer"].append({"name": "frames_traced.render", "unit": "frames",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "render_rays_per_s",
                           "workloads": ["cornell_wide.preview"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = core.load_cell("cornell_wide.preview", root=tmp_path)
    assert cell.config["width"] == 1280 and cell.traffic["spp"] == 4
    assert "frames_traced.render" in [m["name"] for m in cell.per_layer]
    assert core.metric_reader("frames_traced.render",
                              root=tmp_path)({"units": 8}) == 8.0


def _last_line(res, capsys) -> dict:
    core.emit(res)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "compared"
    for name, c in last["compared"].items():
        assert f"compared {name} = " in err
        assert set(c) == {"value", "limit"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    return last


@pytest.mark.parametrize("cell,metrics", [
    ("cornell.render", {"render_rays_per_s", "frame_ms_p95", "setup_s"}),
    ("cornell.train", {"train_step_ms", "setup_s"})])
def test_a_short_run_prints_the_contract_line(cell, metrics, capsys):
    res, _ = helpers.run(helpers.small_cell(cell))
    last = _last_line(res, capsys)
    assert last["correct"] is True
    assert last["attempted"] >= 1 and last["failed"] == 0
    assert set(last["metrics"]) == metrics
