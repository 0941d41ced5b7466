"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root (``-m cuda`` for the one that needs the card). Cells run
here on the CPU at their own sizes, the harness's look for a card
skipped."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cell_of(name: str):
    """The cell as ``BENCHMARK.json`` has it."""
    from benchmark.harness import registry

    return registry.find_cell(name, registry.load_spec(ROOT))


def cpu_devices(cell):
    return [torch.device("cpu")] * cell.chips
