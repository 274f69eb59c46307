"""The control of every cell: the port's own int8 path switched on, the step
below the bf16 that the configurations state. It has to come out as not
correct, on three seeds, at the cell's own size. On the card only:

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda -s
"""
import json

import pytest
import torch

from portbench import run, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (4100000001, 4100000002, 4100000003)
SECONDS = 2.0  # a short window: the check reads what it produced


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_int8_control_is_not_correct(card, cell):
    config = spec.load_config(spec.workload(BENCH, cell)["config"])
    config["int8"] = True
    for seed in SEEDS:
        result = run.run_cell(cell, seed, SECONDS, False, card, bench=BENCH, config=config)
        print(json.dumps({"cell": cell, "seed": seed, "control": "int8",
                          "checks": result["checks"], "agreement": result["agreement"]}))
        assert not result["correct"], f"{cell}: the int8 control passed on seed {seed}"
