"""The benchmark's own tests: they import its modules by the paths run.py
puts first (the checkout's root and proofbench/)."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)
