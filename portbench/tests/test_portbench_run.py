"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped), the traced reduction, and the faults the output check must catch."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import readers, run, spec, system, trace

BENCH = spec.load_benchmark()
CPU = torch.device("cpu")
SEED = 2**31 + 77
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
# Frames large enough that one decision is a small share of a level's (24
# superblocks a frame), and one dispatch of the overlap loop covers the pool.
TINY = {
    "cascade": dict(resolution=[384, 256], pool_frames=2, check_frames=2, frames_per_dispatch=2,
                    batch_size=256, calib_blocks=64, warm_dispatches=1, host_dispatches=2,
                    trace_dispatches=1),
    "blocks": dict(dataset_blocks=1024, batch_size=256, calib_blocks=64, check_blocks=512),
}


def tiny(cell):
    traffic = spec.load_traffic(spec.workload(BENCH, cell)["traffic"])
    traffic.update(TINY[traffic["kind"]])
    return traffic


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["v6_unified.offline_1080p", "v6_stages.live_1440p",
                                  "v6_stages.blocks_16px"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_prints_the_contracts_keys(cell, traced):
    result = run.run_cell(cell, SEED, 0.2, traced, CPU, traffic=tiny(cell))
    line = json.loads(json.dumps(result))
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    e2e, per_layer = spec.cell_metrics(BENCH, cell)
    names = {m["name"] for m in (per_layer if traced else e2e)}
    assert set(line["metrics"]) <= names
    if not traced:
        assert set(line["metrics"]) == names
    else:  # off the card only host-clock metrics read anything
        assert set(line["metrics"]) <= {"cascade_host_ms"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and spec.UNIT.match(m["unit"])
    assert line["device"]["platform"] == "cpu" and line["build_s"] == 0.0  # no card, no build
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_seed_gives_the_same_inputs_and_weights():
    from portbench.loops import Cascade
    from portbench.weights import make_level_models
    cell = "v6_unified.offline_1080p"
    config = spec.load_config("v6_unified")
    family = spec.load_family(config["family"])
    made = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(SEED)
        mix = Cascade(tiny(cell), gen, CPU)
        models = make_level_models(family, config, mix.calib, gen, CPU)
        made.append((mix.pool, models[8]["unified"]["backbone.conv1.weight"]))
    assert np.array_equal(made[0][0], made[1][0]) and torch.equal(made[0][1], made[1][1])


class Altered:
    """The system with every 5th answer of each level's predictor (of those
    in ``levels``, all by default) altered where it is produced."""

    def __init__(self, levels=None):
        self.levels = levels

    def __getattr__(self, name):
        return getattr(system, name)

    def build_predictors(self, *args, **kwargs):
        def alter(fn):
            def predict(images):
                out = dict(fn(images))
                final = out["final"].clone()
                final[::5] = (final[::5] + 1) % 8
                out["final"] = final
                if "stage2_pred" in out:  # the block outputs say the same as the label
                    out["stage2_pred"] = out["stage2_pred"].clone()
                    out["stage2_pred"][::5] = (out["stage2_pred"][::5] + 1) % 3
                return out
            return predict
        return {k: alter(v) if self.levels is None or k in self.levels else v
                for k, v in system.build_predictors(*args, **kwargs).items()}


@pytest.mark.parametrize("cell", ["v6_unified.offline_1080p", "v6_stages.blocks_16px"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell):
    result = run.run_cell(cell, SEED, 0.2, False, CPU, traffic=tiny(cell), system=Altered())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["v6_stages.offline_1080p", "v6_stages.live_1440p"])
def test_answers_altered_at_64_px_alone_are_not_correct(cell):
    result = run.run_cell(cell, SEED, 0.2, False, CPU, traffic=tiny(cell),
                          system=Altered(levels={64}))
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["sure_flip_share_64"]["value"] > checks["sure_flip_share_64"]["limit"]
    for px in (32, 16, 8):  # the other levels read as sound
        assert checks[f"sure_flip_share_{px}"]["value"] <= checks[f"sure_flip_share_{px}"]["limit"]


def test_a_tree_assembled_wrong_is_not_correct():
    class Scrambled(Altered):
        def predict_partition_trees(self, *args, **kwargs):
            out = system.predict_partition_trees(*args, **kwargs)
            out["trees"] = out["trees"].flip(1)
            return out

        def build_predictors(self, *args, **kwargs):
            return system.build_predictors(*args, **kwargs)

    cell = "v6_unified.offline_1080p"
    result = run.run_cell(cell, SEED, 0.2, False, CPU, traffic=tiny(cell), system=Scrambled())
    assert result["correct"] is False and result["checks"]["trees_wrong"]["value"] > 0


def test_a_recurring_block_counts_once_per_answer():
    from portbench import check
    plane = np.zeros((72, 64), dtype=np.uint16)  # 8 zero rows pad it to two superblocks
    plane[:64] = np.arange(64 * 64, dtype=np.uint16).reshape(64, 64)
    blocks = check.ref.quad_tile(check.ref.tile_superblocks(plane), 8)
    answers = np.zeros(len(blocks), dtype=np.int64)
    assert check.first_of_each(blocks, answers).sum() == 64 + 1  # the zero blocks are one
    answers[-1] = 3
    assert check.first_of_each(blocks, answers).sum() == 64 + 2


def test_summarize_busy_gaps_and_readers():
    ms = 1_000_000
    ev = {"ranges": [("traced_window", 0, 100 * ms), ("cascade_call", 0, 40 * ms),
                     ("level_8", 10 * ms, 30 * ms), ("to_host", 60 * ms, 100 * ms)],
          "device": [("void fused_group12_wgmma_kernel<2>(float)", 20 * ms, 50 * ms),
                     ("Memcpy DtoH", 45 * ms, 60 * ms)],
          "kernels": [("void fused_group12_wgmma_kernel<2>(float)", 20 * ms, 50 * ms)]}
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(0.1) and s["busy_s"] == pytest.approx(0.04)
    idle = dict(s["idle_gaps"])
    assert idle["level_8"] == pytest.approx(0.02) and idle["to_host"] == pytest.approx(0.04)
    assert s["device_ops"][0] == ["fused_group12_wgmma_kernel<2>", pytest.approx(0.03)]
    config = spec.load_config("v6_stages")
    k5 = spec.load_count("K5")
    s.update(frames=2, level_rows={8: 1000})
    summary = {"config": config, "family": spec.load_family("stages"), "peaks": spec.peaks(),
               "on_card": True, "trace": s}
    rows = 1000 * 4  # four stage trunks
    bound = max(rows * k5.ops(config, 8) / 989e12,
                (rows * k5.io_bytes(config, 8) + k5.weight_bytes(config, 8)) / 3.35e12)
    assert readers.roofline(summary, "K5") == pytest.approx(100 * bound / 0.03)
    assert readers.roofline(summary, "K1") is None
    assert readers.launches(summary, "frames") == 0.5
    assert readers.idle_share(summary) == pytest.approx(60.0)


def _python(code, cwd):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = ("import json, torch; from portbench import run, spec; "
            "from portbench.tests.test_portbench_run import tiny; "
            "torch.set_num_threads(2); "
            "run.run_cell('v6_stages.blocks_16px', 3, 0.1, False, torch.device('cpu'), "
            "traffic=tiny('v6_stages.blocks_16px')); print(json.dumps(run.forbidden_modules()))")
    out = _python(code, spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    code = ("import sys, portbench.reference.cascade, portbench.weights, portbench.check; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('av1tpu')))")
    out = _python(code, spec.ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "av1tpu_torch.models", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_without_a_card_the_command_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "v6_stages.offline_1080p", "--seed", "1", "--seconds", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
