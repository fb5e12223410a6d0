"""The harness finds every cell, configuration, traffic mix, limit and
metric of ``BENCHMARK.json`` by name, and takes a new one from files
alone."""

import json
import math

import pytest

from gpubench.counts import flops
from gpubench.harness import spec
from gpubench.readers import mfu, percentile, rate

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_files(name):
    cell = spec.load_cell(name)
    assert cell.traffic["kind"] in ("train", "resynth")
    assert cell.config["precision"] == {**cell.config["precision"],
                                        "dtype": "float32", "tf32": False}
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_every_metric_has_a_reader_and_each_moves_a_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        data = spec.load_json(spec.HERE / "metrics" / f"{m['name']}.json")
        assert (spec.HERE / "readers" / f"{data['reader']}.py").is_file()
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_each_configuration_file_is_used_and_unique():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["reduced"] == []
        assert spec.load_json(spec.ROOT / c["file"])["name"] == c["name"]


def test_a_new_cell_config_mix_and_metric_load_from_files_alone(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell by
    writing files and entries; no code names them."""
    base = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (base / sub).mkdir(parents=True)
    config = spec.load_json(spec.HERE / "configs" / "golf-ff.json")
    config["name"] = "golf-ff-b2"
    (base / "configs" / "golf-ff-b2.json").write_text(json.dumps(config))
    mix = dict(spec.load_json(spec.HERE / "traffic" / "train-b64x2s.json"),
               batch=2)
    (base / "traffic" / "train-b2x2s.json").write_text(json.dumps(mix))
    (base / "limits" / "golf-ff-b2.train-b2x2s.json").write_text(
        json.dumps({"loss_gap": {"limit": 1e-4}}))
    (base / "metrics" / "steps_per_s.json").write_text(json.dumps(
        {"reader": "rate", "amount": "attempted", "over": "window_s"}))
    for m in BENCH["end_to_end"]:
        src = spec.HERE / "metrics" / f"{m['name']}.json"
        (base / "metrics" / src.name).write_text(src.read_text())
    bench = {
        "configs": [{"name": "golf-ff-b2",
                     "file": "gpubench/configs/golf-ff-b2.json"}],
        "workloads": [{"name": "golf-ff-b2.train-b2x2s",
                       "config": "golf-ff-b2", "traffic": "train-b2x2s",
                       "chips": 1}],
        "end_to_end": [m for m in BENCH["end_to_end"]
                       if m["name"] == "setup_s"],
        "per_layer": [{"name": "steps_per_s", "unit": "1/s",
                       "better": "higher", "layer": "trainer",
                       "moves": "setup_s"}],
    }
    cell = spec.load_cell("golf-ff-b2.train-b2x2s", bench, root=tmp_path)
    assert cell.traffic["batch"] == 2
    assert cell.config["name"] == "golf-ff-b2"
    assert [m.name for m in cell.per_layer] == ["steps_per_s"]
    assert cell.per_layer[0].read({"attempted": 30, "window_s": 10.0}) == 3.0
    assert cell.end_to_end[0].read({"setup_s": 12.5}) == 12.5
    with pytest.raises(KeyError):
        spec.load_cell("golf-ff-b2.missing", bench, root=tmp_path)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    assert rate.read({}) is None
    assert percentile.read({"latencies_ms": [1.0]}) is None
    assert mfu.read({}) is None
    values = list(range(1, 201))
    assert percentile.read({"latencies_ms": values}) == pytest.approx(
        190.95)
    assert math.isclose(rate.read({"audio_s": 64.0, "window_s": 2.0}), 32.0)


def test_mfu_reads_the_profiled_steps_flops_over_their_busy_time():
    cell = spec.load_cell("golf-ss.train-b64x2s")
    rec = {"traffic": cell.traffic, "config": cell.config,
           "trace_steps": 6, "busy_s": 1.2, "window_s": 30.0,
           "attempted": 140}
    work = 6 * flops.train_step(cell.config, 64, 48000)
    assert mfu.read(rec) == pytest.approx(100 * work / 1.2 / 67e12)
    # the untraced window does not enter it
    assert mfu.read(dict(rec, window_s=1.0, attempted=1)) == mfu.read(rec)
    assert mfu.read(dict(rec, busy_s=0.0)) is None
