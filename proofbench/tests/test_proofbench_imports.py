"""What the benchmark loads: no JAX and no JAX package anywhere, and nothing
of the program in the reference.  Top-level names are compared whole
(`plonky2_bn254_tpu_torch` begins with `plonky2_bn254_tpu`)."""

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "plonky2_bn254_tpu"}


def _top_level_after(imports: list) -> set:
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(HERE)!r}]\n"
            + "".join(f"{line}\n" for line in imports)
            + "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, cwd=str(ROOT)).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def _modules(sub: str) -> list:
    return sorted(p for p in (HERE / sub).glob("*.py") if p.name != "__init__.py")


def _package_imports(package: str) -> list:
    """`import <package>.<module>` for every module under proofbench/<package>."""
    names = []
    for path in sorted((HERE / package).rglob("*.py")):
        parts = path.relative_to(HERE).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return [f"import {name}" for name in names]


def test_whole_names_not_prefixes():
    assert "plonky2_bn254_tpu_torch".split(".")[0] not in FORBIDDEN


def test_harness_and_program_load_no_jax():
    lines = ["import importlib.util", "import run"]
    lines += _package_imports("yardstick") + _package_imports("reference")
    for sub in ("drivers", "metrics"):
        for i, path in enumerate(_modules(sub)):
            lines.append(f"s = importlib.util.spec_from_file_location('m_{sub}_{i}', {str(path)!r});"
                         f" s.loader.exec_module(importlib.util.module_from_spec(s))")
    # what a batch cell's set-up imports of the program
    lines.append("import plonky2_bn254_tpu_torch.starks.table, plonky2_bn254_tpu_torch.prover.prove")
    for cfg in (HERE / "configs").glob("*.json"):
        lines.append(f"import {json.loads(cfg.read_text())['program']['module']}")
    loaded = _top_level_after(lines)
    assert "plonky2_bn254_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    imports = _package_imports("reference")
    assert "import reference.outer" in imports and "import reference.machines.fq_exp" in imports
    loaded = _top_level_after(imports)
    assert "plonky2_bn254_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN
    assert "torch" not in loaded
