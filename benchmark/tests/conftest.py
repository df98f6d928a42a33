"""The benchmark's CPU tests: the repository root on the import path, and
small tables drawn on the CPU."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Rows of the tables the tests draw: three whole groups and a part.
ROWS = 3 * 32768 + 1234


@pytest.fixture
def rows():
    return ROWS
