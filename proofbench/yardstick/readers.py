"""What the metric files share: a span's mean over the traced run's
window proofs, and the readings of the profiled window."""

from __future__ import annotations

# the hand kernels, as the profiler names them (the transcript kernel apart)
HAND_KERNELS = ("hash_leaves_kernel", "hash_leaves_group_kernel", "tree_levels_kernel",
                "permute_states_kernel", "permute_states_group_kernel", "ntt_rows_kernel",
                "ntt_columns_kernel", "ntt_rows_t_kernel")


def span_mean(record, name):
    spans = record.get("spans", {}).get(name)
    return sum(spans) / len(spans) if spans else None


def idle_percent(record):
    """1 - (union of device operations' intervals) / window, in %."""
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def busy_s(record):
    """The union of device operations' intervals in the profiled window, s."""
    prof = record.get("profile")
    return prof["busy_s"] if prof and prof["busy_s"] > 0 else None


def launches(record):
    prof = record.get("profile")
    return float(prof["launches"]) if prof else None


def roofline_percent(record, kernels=HAND_KERNELS):
    """The least time of the hand kernels' work (yardstick/work.py) over the
    device time of `kernels` in the profiled window, in %."""
    prof = record.get("profile")
    if not prof or "least_kernel_s" not in record:
        return None
    spent = sum(s for name, s in prof["device_s"].items() if any(k in name for k in kernels))
    return 100.0 * record["least_kernel_s"] / spent if spent > 0 else None
