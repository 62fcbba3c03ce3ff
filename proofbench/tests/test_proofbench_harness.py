"""The harness on the CPU: BENCHMARK.json against the contract's forms, every
file found by name, the input draw, the window rule, the profiler
reduction and the work model."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

import run
from yardstick import profile, traffic, window, work

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in METRICS]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert len(set(w["name"] for w in BENCH["workloads"])) == len(BENCH["workloads"])
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in ([c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and m["name"].split(".")[0].endswith("_roofline"):
            assert m["better"] == "higher"
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in run.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = run.cell_metrics(BENCH, w["name"], True)
        assert layer
        # a per-layer metric's end-to-end metric is reported in each cell it names
        assert all(m["moves"] in reported for m in layer)
        assert w["chips"] in (1, 4)


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        entry, config, mix, driver = run.cell_files(BENCH, w["name"])
        assert entry is w and config["name"] == w["config"] and driver.exists()
        assert config["reduced"] == next(c for c in BENCH["configs"]
                                         if c["name"] == w["config"])["reduced"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("proofbench/")
    for m in METRICS:
        assert (run.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_cells_of_one_configuration_load_one_file():
    by_config = {}
    for w in BENCH["workloads"]:
        _, config, mix, _ = run.cell_files(BENCH, w["name"])
        by_config.setdefault(w["config"], []).append(config)
    for configs in by_config.values():
        assert all(c == configs[0] for c in configs)
    fq = [w for w in BENCH["workloads"] if w["config"] == "fq_exp"]
    assert fq and all(run.cell_files(BENCH, w["name"])[1]["machine"] == "fq_exp" for w in fq)


def test_new_cell_config_traffic_and_metric_are_files_alone(tmp_path, monkeypatch):
    """A later cell is new files plus BENCHMARK.json entries: run.py finds
    them with no edit of a file that is there, and so do the reference (a
    new machine) and the draw (a new operand kind)."""
    bench_dir = tmp_path / "proofbench"
    shutil.copytree(run.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "reference" / "machines" / "fq_exp_copy.py").write_text(
        "import dataclasses\n\nfrom . import fq_exp\n\n\n"
        "def machine():\n    return dataclasses.replace(fq_exp.machine(), name='fq_exp_copy')\n")
    (bench_dir / "yardstick" / "operands" / "fq_square.py").write_text(
        "from reference import bn254\n\nfrom . import fq\n\n\n"
        "def draw(g, spec=None):\n    return fq.draw(g) ** 2 % bn254.P\n")
    config = json.loads((bench_dir / "configs" / "fq_exp.json").read_text())
    config["name"] = config["machine"] = "fq_exp_copy"
    config["operands"] = ["scalar", "fq_square"]
    (bench_dir / "configs" / "fq_exp_copy.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "batch128.json").read_text())
    mix["ops_per_proof"] = 256
    (bench_dir / "traffic" / "batch256.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "proofs_per_s.py").write_text(
        "def read(record):\n    return record['proofs'] / record['window_s']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "fq_exp_copy.batch256", "config": "fq_exp_copy",
                               "traffic": "batch256", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "proofs_per_s", "unit": "proofs/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["fq_exp_copy.batch256"]})
    monkeypatch.setattr(run, "HERE", bench_dir)
    entry, config, mix, driver = run.cell_files(bench, "fq_exp_copy.batch256")
    assert config["name"] == "fq_exp_copy" and mix["ops_per_proof"] == 256
    assert driver == bench_dir / "drivers" / "batch.py"
    names = [m["name"] for m in run.cell_metrics(bench, "fq_exp_copy.batch256", False)]
    assert names == ["setup_s", "proofs_per_s"]
    reader = run.load_module(bench_dir / "metrics" / "proofs_per_s.py", "test_metric")
    assert reader.read({"proofs": 3, "window_s": 6.0}) == 0.5
    assert "proofs_per_s" not in [m["name"] for m in run.cell_metrics(bench, "g1.batch128",
                                                                       False)]
    # the reference and the draw of the copy, as a run in that checkout loads them
    code = ("import json, sys; sys.path[:0] = [sys.argv[1]]\n"
            "from reference import machines\nfrom yardstick import traffic\n"
            "cfg = json.load(open(sys.argv[1] + '/configs/fq_exp_copy.json'))\n"
            "m = machines.machine(cfg['machine'])\n"
            "ops = traffic.operations(3, 'window', 0, cfg['operands'], 2, {'high_bits': 8, "
            "'high_shift': 8, 'low_bits': 8})\n"
            "print(json.dumps([m.name, m.width, len(m.ctl_values(ops)[1]), "
            "[str(x) for _, x in ops]]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(bench_dir)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    name, width, n_out, xs = json.loads(out.strip().splitlines()[-1])
    from reference import bn254

    assert (name, width, n_out) == ("fq_exp_copy", 427, 2)
    assert all(bn254.sqrt(int(x)) is not None for x in xs)  # squares: the new kind drew them


def _draw(seed, k, config="g1_scalar_mul"):
    cfg = json.loads((run.HERE / "configs" / f"{config}.json").read_text())
    mix = json.loads((run.HERE / "traffic" / "batch128.json").read_text())
    return traffic.operations(seed, "window", k, cfg["operands"], 4, mix["scalar"])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_draw_is_a_pure_function_of_the_seed(seed):
    first, again = _draw(seed, 0), _draw(seed, 0)
    assert first == again
    assert _draw(seed, 1) != first  # every proof gets new inputs
    assert _draw(seed + 1, 0) != first
    from reference import bn254

    for s, x, offset in first:
        assert bn254.on_curve(x) and bn254.on_curve(offset)
        assert 1 << 192 <= s < 1 << 255
    for s, x in _draw(seed, 0, "fq_exp"):
        assert 0 <= x < bn254.P


def test_streams_do_not_share_draws():
    assert traffic.rng(9, "window", 0).integers(0, 2**62) != traffic.rng(9, "warmup", 0).integers(
        0, 2**62)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,started", [
    ([3.0] * 10, 10.0, 4),     # starts at 0, 3, 6, 9; the fourth ends at 12
    ([30.0, 30.0], 10.0, 1),   # one proof longer than the window
    ([2.0] * 10, 4.0, 2),      # a proof due exactly at the limit does not start
])
def test_window_counts_every_proof_started_and_only_those(durations, seconds, started):
    clock = FakeClock()
    calls = []

    def step(k):
        calls.append(k)
        clock.t += durations[k]
        return k != 1

    win = window.closed_loop(step, seconds, clock)
    assert calls == list(range(started)) and win.proofs == started
    assert win.seconds == pytest.approx(sum(durations[:started]))
    assert win.failed == (1 if started > 1 else 0)


def test_profile_reduction():
    events = [
        (profile.WINDOW, False, 0.0, 100.0),
        ("scope:aux", False, 0.0, 50.0),
        ("scope:quotient", False, 50.0, 100.0),
        ("k1", True, 10.0, 20.0),
        ("k1", True, 15.0, 30.0),
        ("Memcpy HtoD", True, 60.0, 70.0),
        ("k2", True, 90.0, 95.0),
    ]
    r = profile.reduce_events(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)  # 10-30, 60-70, 90-95
    assert r["launches"] == 3
    assert r["device_s"]["k1"] == pytest.approx(25e-6)
    assert r["gaps"][0] == ("aux", pytest.approx(30e-6))  # 30-60 opens in aux
    assert [g[0] for g in r["gaps"]] == ["aux", "quotient", "aux", "quotient"]


def test_work_model_pins():
    """The frozen roofline arithmetic at keys the program's bound table
    pinned (K1 [2^17, 781] 19.5340 ms, [64, 16] 0.0113 ms; the iNTT and
    LDE of [781, 2^16])."""
    assert work.hash_leaves_s(1 << 17, 781) * 1e3 == pytest.approx(19.5340, abs=1e-4)
    assert work.hash_leaves_s(64, 16) * 1e3 == pytest.approx(0.0113, abs=1e-4)
    assert work.intt_s(781, 1 << 16) * 1e3 == pytest.approx(0.50677, abs=1e-4)
    assert work.coset_lde_s(781, 1 << 16, 1) * 1e3 == pytest.approx(1.10158, abs=1e-4)
    assert work.INT32_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)
    cfg = json.loads((run.HERE / "configs" / "g1_scalar_mul.json").read_text())["stark_config"]
    assert 0.030 < work.batch_prove_least_s(781, 456, 16, cfg) < 0.040


def test_profile_reduction_leaves_out_skipped_scopes():
    events = [
        (profile.WINDOW, False, 0.0, 100.0),
        ("scope:aux", False, 0.0, 40.0),
        ("k1", True, 10.0, 20.0),
        (profile.SKIP + "quotient", False, 40.0, 40.0),  # collection off
        (profile.SKIP + "quotient", False, 90.0, 90.0),  # and on again
        ("k2", True, 95.0, 100.0),
    ]
    r = profile.reduce_events(events)
    assert r["window_s"] == pytest.approx(50e-6)
    assert r["busy_s"] == pytest.approx(15e-6)
    assert sorted(g[1] for g in r["gaps"]) == pytest.approx([5e-6, 10e-6, 20e-6])


def test_device_trace_metric_reads_the_profiled_busy_seconds():
    """G1's untraced run reports a metric read from the device trace, so
    run.py has its last proof made again under the profiler; the reader
    takes the device's busy seconds from that window, and nothing where
    there is none."""
    sources = {m["name"]: m["source"] for m in run.cell_metrics(BENCH, "g1.batch128", False)}
    assert sources.get("prove_device_s") == "device_trace"
    reader = run.load_module(run.HERE / "metrics" / "prove_device_s.py", "test_busy")
    assert reader.read({}) is None
    assert reader.read({"profile": {"busy_s": 0.0, "window_s": 2.0}}) is None
    assert reader.read({"profile": {"busy_s": 1.378, "window_s": 8.0}}) == 1.378
