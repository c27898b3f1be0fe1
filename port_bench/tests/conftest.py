"""The benchmark's CPU tests import the harness from the repository root."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
