"""Cells, configurations, traffic, limits and metric readers, all found by
name from BENCHMARK.json; the file keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from portbench import compare, harness, trace

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    n = 24
    full = ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200)
    assert full <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    spec = harness.find_cell(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["limits"] and set(spec["limits"]) <= set(compare.GAPS)
    assert all(v > 0 for v in spec["limits"].values())
    assert spec["traffic"]["n_chains"] in (128, 512, 1024)
    names = [m["name"] for m in spec["per_layer"]]
    assert ("attention_roofline" in names) == (
        spec["config"].get("esm2") is not None)
    # the device-paced rate under its own bound: only in cells the device
    # paces (a transformer's), and not in each of them
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e - {"chain_steps_per_s.device_paced"} == {"chain_steps_per_s",
                                                       "setup_s"}
    if "chain_steps_per_s.device_paced" in e2e:
        assert spec["config"].get("esm2") is not None


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = harness.reader(metric)
    run = {"trace": None, "launches": {k: 0 for k in trace.kernels()},
           "config": harness.load_json(os.path.join(
               harness.HERE, "configs", "poe-potts-cnn.json")),
           "setup_s": 1.0, "chain_steps_per_s": 2.0, "steps": 1,
           "chains": 1, "L": 10, "energy_calls": 2}
    v = read(run)
    if metric in ("setup_s", "chain_steps_per_s",
                  "chain_steps_per_s.device_paced"):
        assert v in (1.0, 2.0)
    else:
        assert v is None


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no-such.cell")


def test_window_steps_fill_whole_segments():
    assert harness.window_steps(10.0, 0.131, 50) == 50
    assert harness.window_steps(30.0, 0.131, 50) == 200
    assert harness.window_steps(1.0, 1.0, 50) == 50
    assert harness.sampler_seed(2 ** 31 + 5) != harness.sampler_seed(5)


@pytest.mark.parametrize("cell", CELLS)
def test_every_key_of_the_configuration_drives_the_run(cell):
    cfg = harness.find_cell(cell)["config"]
    st = harness.cli_settings(cfg)
    assert st == {"compute_dtype": "f32", "pas_length": 2,
                  "nmut_threshold": 10, "temp": 2.0}
    bf16 = json.loads(json.dumps(cfg))
    bf16["potts"]["dtype"] = bf16["cnn"]["dtype"] = "bfloat16"
    assert harness.cli_settings(bf16)["compute_dtype"] == "bf16"
    for path, value in ((("cnn", "dtype"), "bfloat16"),
                        (("sampler", "sampler"), "PPDE"),
                        (("potts", "dtype"), "float16")):
        bad = json.loads(json.dumps(cfg))
        bad[path[0]][path[1]] = value
        with pytest.raises(ValueError):
            harness.cli_settings(bad)
    if cfg.get("esm2") is not None:
        bad = json.loads(json.dumps(cfg))
        bad["esm2"]["dtype"] = "float32"
        with pytest.raises(ValueError):
            harness.cli_settings(bad)
