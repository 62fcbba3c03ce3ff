"""The benchmark of the PyTorch/CUDA prover (`plonky2_bn254_tpu_torch`).

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Everything is found by name:
  - the cell in BENCHMARK.json's `workloads` (its configuration, traffic
    mix and chips);
  - the configuration in proofbench/configs/<config>.json, and the machine
    and operand kinds it names, in proofbench/reference/machines/<machine>.py
    and proofbench/yardstick/operands/<kind>.py;
  - the traffic mix in proofbench/traffic/<traffic>.json, which names its
    driver, proofbench/drivers/<driver>.py;
  - each metric in proofbench/metrics/<metric>.py (`read(record)`, None
    where it finds nothing to read): with --trace 0 the cell's end-to-end
    metrics, with --trace 1 its per-layer metrics.

Set-up (imports, the kernel build on a first run, the driver's warm-up) is
timed from the top of this file to the window's start.  The window is a
closed loop of one client (yardstick/window.py).  Once it has closed, the
peak device memory is read, the program's state is dropped, and the
driver's judge holds a sample of the window's proofs against the plain
reference (proofbench/reference/).  Progress and each compared number with
its limit go to standard error; the last line of standard output is the
result.  Without as many CUDA cards as the cell asks for, or if a JAX
module is loaded once the window has closed, the run exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "plonky2_bn254_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, cell: str) -> tuple:
    """(the cell's entry, its configuration, its traffic mix, its driver's
    path), each found by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"run.py: no cell {cell!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return entry, config, mix, HERE / "drivers" / f"{mix['driver']}.py"


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries this run reports: per-layer ones when traced,
    else end-to-end ones; each only where its `workloads` name the cell."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: pathlib.Path) -> None:
    """Every compile cache inside the checkout, at fixed paths."""
    cache = root / ".proofbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


class ForbiddenModules(RuntimeError):
    pass


def run_cell(bench: dict, cell: str, seed: int, seconds: float, traced: bool, device,
             patch=None) -> dict:
    """One run of `cell` on `device` after the card check: set-up, the
    window, the metrics and the judge; the result line as a dict.
    `patch(driver)`, for the benchmark's own tests, is applied once the
    driver's set-up is done."""
    from yardstick import host, window

    entry, config, mix, driver_path = cell_files(bench, cell)
    metrics = cell_metrics(bench, cell, traced)
    # the profiled re-prove runs where a reported metric reads the device trace
    profiled = traced or any(m["source"] == "device_trace" for m in metrics)
    driver = load_module(driver_path, f"proofbench_driver_{mix['driver']}").Driver(
        config, mix, seed, device, traced, log, profiled=profiled)
    driver.setup()
    if patch is not None:
        patch(driver)
    setup_s = time.perf_counter() - T_START
    log(f"# set-up {setup_s:.3f} s")

    win = window.closed_loop(driver.step, seconds)
    log(f"# window: {win.proofs} proofs in {win.seconds:.3f} s, walls "
        + ", ".join(f"{w:.3f}" for w in win.walls) + f"; highest {max(win.walls):.3f} s")
    record = {"setup_s": setup_s, "window_s": win.seconds, "proofs": win.proofs,
              "ops": win.proofs * driver.ops_per_proof()}
    record.update(driver.after_window())
    device_rec = host.device_record(entry["chips"])
    driver.release()

    values = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py",
                            "proofbench_metric_" + m["name"].replace(".", "_")).read(record)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = driver.judge()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules of JAX or of the JAX package were loaded: {found}")
    result = {"correct": win.failed == 0 and all(v <= lim for v, lim in checks.values()),
              "attempted": win.proofs, "failed": win.failed, "metrics": values,
              "device": device_rec}
    if traced and "profile" in record:
        prof = record["profile"]
        device_rec["busy_s"], device_rec["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = {
            "device_ops": sorted(prof["device_s"].items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [list(g) for g in prof["gaps"][:10]]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        log(f"check {name}: {v} (limit {lim})")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    bench = load_json(root / "BENCHMARK.json")
    entry = cell_files(bench, args.workload)[0]
    cache_dirs(root)
    sys.path[:0] = [str(root), str(HERE)]

    import torch

    from yardstick import host

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"run.py: the cell needs {entry['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    log(f"# {host.power_limit()}; {torch.cuda.device_count()} card(s)")
    log(f"# {host.cpu_line()}")
    log(f"# cell {args.workload}: config {entry['config']}, traffic {entry['traffic']}, "
        f"seed {args.seed}, {args.seconds:g} s, trace {args.trace}")
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    except ForbiddenModules as err:
        log(f"run.py: {err}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
