"""The device and host a run stands on."""

from __future__ import annotations

import os
import platform
import subprocess


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cpu_line() -> str:
    model = platform.processor() or platform.machine() or "unknown"
    try:
        res = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30, check=True)
        model = next((ln.split(":", 1)[1].strip() for ln in res.stdout.splitlines()
                      if ln.startswith("Model name")), model)
    except (OSError, subprocess.SubprocessError):
        pass
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    return f"host: {model}, {os.cpu_count()} cores, load average {load}"


def device_record(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}
