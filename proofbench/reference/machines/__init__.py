"""The batch STARK machines, one module each, found by name.

`machine(name)` loads `machines/<name>.py` and calls its `machine()`, so a
configuration's `machine` key names a module here and a new machine is a
new file.
"""

from __future__ import annotations

import importlib
import re

from ..stark import Machine


def machine(name: str) -> Machine:
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"no machine named {name!r}")
    return importlib.import_module(f"{__name__}.{name}").machine()
