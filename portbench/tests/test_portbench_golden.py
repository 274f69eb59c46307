"""Golden readings, recorded before the model families moved out of the
shared modules (``golden.json``): the same seed has to give bit-identical
weights, the same output-check numbers in every cell at a tiny size, and the
same operation counts. A model family's files change none of them."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import run, spec
from portbench.data import frame
from portbench.tests.test_portbench_run import tiny
from portbench.weights import make_level_models

GOLDEN = json.loads((Path(__file__).parent / "golden.json").read_text())
CPU = torch.device("cpu")
SEED = 2**31 + 77
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _digest(sd):
    h = hashlib.sha256()
    for name, t in sd.items():
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["v6_stages", "v6_unified"])
def test_the_seed_gives_the_same_weights(name):
    """Every tensor of every model at the four levels, calibrated on 16
    blocks a level (8 calibrate, 8 probe)."""
    config = spec.load_config(name)
    gen = torch.Generator().manual_seed(5)
    calib = {}
    for px in (64, 32, 16, 8):
        blocks = frame(gen, 4 * px, 4 * px, CPU).reshape(4, px, 4, px)
        calib[px] = blocks.transpose(0, 2, 1, 3).reshape(-1, px, px)
    models = make_level_models(spec.load_family(config["family"]), config, calib, gen, CPU)
    got = {f"{px}/{kind}": _digest(sd) for px, level in models.items()
           for kind, sd in level.items()}
    assert got == GOLDEN["weights"][name]


@pytest.mark.parametrize("cell", CELLS)
def test_the_seed_gives_the_same_check_numbers(cell):
    result = run.run_cell(cell, SEED, 0.01, False, CPU, traffic=tiny(cell))
    want = GOLDEN["runs"][cell]
    assert result["correct"] is want["correct"]
    assert {k: v["value"] for k, v in result["checks"].items()} == want["checks"]
    assert {k: float(v) for k, v in result["agreement"].items()} == want["agreement"]


@pytest.mark.parametrize("name", ["v6_stages", "v6_unified"])
def test_the_same_operation_counts(name):
    config = spec.load_config(name)
    family = spec.load_family(config["family"]).reference
    want = GOLDEN["counts"][name]
    assert {str(px): family.per_block(config, px) for px in (8, 16, 32, 64)} == want["per_block"]
    assert family.trunks(config) == want["trunks"]
