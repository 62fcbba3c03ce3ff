"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card: name, power limit and maximum SM clock from nvidia-smi;
  2. build the CUDA kernels from plonky2_bn254_tpu_torch/csrc (nvcc, sm_90a),
     and count the SASS instructions of each Goldilocks operation
     (bounds.sass_costs): they must equal the fixed costs the bounds use;
  3. the demo STARK proved on the card must equal its proof on the CPU
     (plain versions) bit for bit;
  4. the main path: 128 G1 scalar multiplications (seed 2024, as bench.py)
     -> generate_trace (2^16 x 781) -> prove at DEFAULT_CONFIG -> verify,
     with every kernel's launch count above zero, and a proof with one
     flipped opening rejected; the wrappers record the shape of every
     launch (kernels.CALLS);
  5. each kernel against its plain PyTorch version on the card, at every
     shape the main path launched it with and at a few odd sizes, with
     torch.equal (exact integer arithmetic: the tolerance is zero); the
     kernel timed at each main-path shape beside its bound (bounds.py), the
     plain version at the largest;
  6. stage times of a steady-state proof from the synchronising timer, and
     the wall times of two more.

Prints the kernel table as one JSON line (each kernel's largest main-path
shape, and every main-path shape with its launches under "shapes"), then the
card line, then {"ok": true, "device": {...}} as the last line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 2024
N_OPS = 128

KERNELS = {
    "K1": ("hash_leaves", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
           "plonky2_bn254_tpu/field/poseidon_pallas.py:385"),
    "K2": ("permute_states", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
           "plonky2_bn254_tpu/field/poseidon_pallas.py:457"),
    "K3": ("intt", "plonky2_bn254_tpu_torch/csrc/ntt.cu",
           "plonky2_bn254_tpu/field/ntt_pallas.py:170"),
    "K4": ("coset_lde", "plonky2_bn254_tpu_torch/csrc/ntt.cu",
           "plonky2_bn254_tpu/field/ntt_pallas.py:240"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def rand_residues(rng, shape, device):
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.interop import tensor_from_u64

    return tensor_from_u64(rng.integers(0, gl.P, size=shape, dtype=np.uint64), device)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the u64 values that the int64 tensors hold."""
    if got.numel() == 0:
        return 0
    flip = -(1 << 63)  # xor with the sign bit: unsigned order becomes signed order
    a, b = got ^ flip, want ^ flip
    diff = torch.maximum(a, b) - torch.minimum(a, b)  # wraps to the u64 difference
    return (int((diff ^ flip).max()) ^ flip) % (1 << 64)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs, after one warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clock_max_mhz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(res.stdout.strip().splitlines()[0])


def kernel_call(kid: str, key: tuple):
    """(wrapper, plain version, (ops, bytes), input shape) of one launch key
    as the wrappers record it in kernels.CALLS."""
    from plonky2_bn254_tpu_torch import bounds
    from plonky2_bn254_tpu_torch.field import ntt_cuda, poseidon_cuda as pc

    if kid == "K1":
        return pc.hash_leaves, pc.hash_leaves_plain, bounds.hash_leaves_work(*key), key
    if kid == "K2":
        return (pc.permute_states, pc.permute_states_plain,
                bounds.permute_states_work(key[0]), (key[0], 12))
    rows, n, out_n, inverse = key
    if kid == "K3":
        kern, plain = (ntt_cuda.intt, ntt_cuda.intt_plain) if inverse else (ntt_cuda.ntt, ntt_cuda.ntt_plain)
        return kern, plain, bounds.ntt_work(rows, n, inverse), (rows, n)
    rate = (out_n // n).bit_length() - 1
    return (lambda x: ntt_cuda.coset_lde(x, rate), lambda x: ntt_cuda.coset_lde_plain(x, rate),
            bounds.coset_lde_work(rows, n, rate), (rows, n))


# Sizes beside the main path's, as launch keys: edge widths, n = 1, n = 2^20,
# the forward NTT, the LDE at rate 2.
ODD_KEYS = {
    "K1": [(1, 781), (5, 13), (3, 0)],
    "K2": [(1,)],
    "K3": [(5, 8, 8, True), (13, 1 << 12, 1 << 12, True), (3, 1 << 20, 1 << 20, True),
           (1, 1, 1, True), (7, 1 << 17, 1 << 17, False)],
    "K4": [(5, 8, 16, False), (1, 1, 2, False), (7, 1 << 12, 1 << 14, False),
           (3, 1 << 16, 1 << 18, False)],
}


def compare_kernels(device, calls: dict, sms: int, clock_mhz: float) -> dict:
    """Each kernel vs its plain version on the card at every key of `calls`
    (the main path's launches; timed, beside the bound of bounds.py) and at
    ODD_KEYS.  Raises on the first disagreement."""
    from plonky2_bn254_tpu_torch import bounds

    rng = np.random.default_rng(SEED)
    results = {}
    for kid, odd in ODD_KEYS.items():
        timed = sorted(calls[kid], key=lambda k: kernel_call(kid, k)[2], reverse=True)
        err, rows = 0, []
        for i, key in enumerate(timed + [k for k in odd if k not in calls[kid]]):
            kern, plain, work, shape = kernel_call(kid, key)
            x = rand_residues(rng, shape, device)
            got = kern(x)
            want = plain(x)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{kid} {key}: {bad} elements differ from the plain version")
            del got, want
            if i < len(timed):
                ms = cuda_ms(lambda: kern(x), reps=20)
                plain_ms = cuda_ms(lambda: plain(x), reps=1) if i == 0 else None
                bound, bound_by = bounds.bound_ms(*work, sms, clock_mhz)
                rows.append({"key": list(key), "launches": calls[kid][key], "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                             "share": bound / ms})
                log(f"  {kid} {key} x{calls[kid][key]}: kernel {ms:.3f} ms, bound {bound:.4f} ms "
                    f"({bound_by}), share {bound / ms:.3f}"
                    + (f", plain {plain_ms:.3f} ms" if plain_ms is not None else ""))
            del x
        n_odd = len([k for k in odd if k not in calls[kid]])
        log(f"  {kid}: equal to plain at {len(timed)} main-path and {n_odd} odd shapes, "
            f"max_abs_err {err}")
        results[kid] = {"max_abs_err": err, "timed": rows}
        torch.cuda.empty_cache()
    return results


def demo_matches_cpu(device) -> None:
    """The demo STARK proved on the card equals its proof on the CPU."""
    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    trace, ctl = demo_trace(np.random.default_rng(SEED))
    on_card = prove_mod.prove(demo_stark(), trace.to(device), ctl, TEST_CONFIG)
    on_cpu = prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG)
    verify_mod.verify(demo_stark(), on_card, ctl, TEST_CONFIG)
    a, b = proof_to_fields(on_card), proof_to_fields(on_cpu)
    if json.dumps(a, default=lambda v: v.tolist()) != json.dumps(b, default=lambda v: v.tolist()):
        raise AssertionError("demo proof on the card differs from the CPU proof")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", 0)

    from plonky2_bn254_tpu_torch import kernels
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG
    from plonky2_bn254_tpu_torch.starks import g1_scalar_mul
    from plonky2_bn254_tpu_torch.starks.table import g1_scalar_mul_stark
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    card = card_line()
    log(f"# card: {card}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    log(f"# build: {time.perf_counter() - t0:.2f} s -> {kernels.BUILD.path}")
    for line in kernels.BUILD.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")

    # ---- op costs, demo proof ----------------------------------------------
    from plonky2_bn254_tpu_torch import bounds

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = clock_max_mhz()
    costs, mul_opcodes = bounds.sass_costs(kernels.BUILD_DIR / "op_probe")
    log(f"# bound: {bounds.INT32_OPS_PER_CLK_PER_SM} int32 ops/clk/SM x {sms} SMs x "
        f"{clock_mhz:.0f} MHz (clocks.max.sm), {bounds.HBM_BYTES_PER_S / 1e12} TB/s")
    log(f"  SASS of csrc/goldilocks.cuh {costs}; gl::mul opcodes {mul_opcodes}")
    if costs != bounds.OP_COST:
        raise AssertionError(f"SASS op costs {costs} differ from bounds.OP_COST {bounds.OP_COST}")

    log("# demo STARK: card proof vs CPU proof")
    demo_matches_cpu(device)
    log("  equal, and verified")

    # ---- main path -------------------------------------------------------
    rng = np.random.default_rng(SEED)
    inputs = [
        (
            int(rng.integers(1, 1 << 63)) << 192 | int(rng.integers(0, 1 << 63)),
            oracle.random_g1(rng),
            oracle.random_g1(rng),
            t,
        )
        for t in range(N_OPS)
    ]
    stark = g1_scalar_mul_stark()
    ctl_values = g1_scalar_mul.generate_ctl_values(inputs)

    def one_proof(tt=None):
        tt = tt or TimingTree(enabled=False)
        with tt.scope("trace gen"):
            trace = g1_scalar_mul.generate_trace(inputs, device=device)
        assert trace.shape == (1 << 16, g1_scalar_mul.LAYOUT.width), trace.shape
        return prove_mod.prove(stark, trace, ctl_values, DEFAULT_CONFIG, timing=tt)

    log(f"# main path: {N_OPS} G1 ops, DEFAULT_CONFIG")
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = one_proof()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  first proof {time.perf_counter() - t0:.2f} s; launches {launches}")
    calls = {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}
    missing = [k for k in kernels.KERNEL_IDS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    t0 = time.perf_counter()
    verify_mod.verify(stark, proof, ctl_values, DEFAULT_CONFIG)
    log(f"  verified in {time.perf_counter() - t0:.2f} s")

    proof.openings.trace_zeta[0] = proof.openings.trace_zeta[0] + GLExt(1)
    try:
        verify_mod.verify(stark, proof, ctl_values, DEFAULT_CONFIG)
    except verify_mod.VerificationError as e:
        log(f"  tampered proof rejected: {e}")
    else:
        raise AssertionError("a proof with a flipped opening was accepted")
    del proof

    log("# kernels vs plain versions at every main-path shape (torch.equal, tolerance 0)")
    kres = compare_kernels(device, calls, sms, clock_mhz)

    # ---- steady state ------------------------------------------------------
    tt = TimingTree(enabled=True)
    one_proof(tt)
    log("# stage times of a steady-state proof (synchronised scopes):")
    for depth, stage, secs in tt.records:
        log(f"  {'  ' * depth}{secs:8.3f}s  {stage}")
    walls = []
    for _ in range(2):  # host-bound: two readings show the host's spread
        t0 = time.perf_counter()
        one_proof()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    log(f"  steady-state proof walls {walls[0]:.3f} s, {walls[1]:.3f} s; best "
        f"{1.0 / wall:.4f} proofs/s, {N_OPS / wall:.2f} G1 ops/s; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    name = torch.cuda.get_device_name(0)

    table = {"kernels": []}
    for kid in kernels.KERNEL_IDS:
        main = kres[kid]["timed"][0]
        table["kernels"].append({
            "name": f"{kid} {KERNELS[kid][0]}", "route": "cuda", "source": KERNELS[kid][1],
            "replaces": KERNELS[kid][2], "launches": launches[kid],
            "max_abs_err": kres[kid]["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "share": main["share"], "key": main["key"],
            "shapes": [{k: r[k] for k in ("key", "launches", "ms", "bound_ms", "share")}
                       for r in kres[kid]["timed"]],
        })
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
