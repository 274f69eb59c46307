"""The two sweep examples of the port (``av1tpu_torch/examples/
per_size_batch_sweep.py``, ``cascade_batch_sweep.py``) and the bench helpers
they time with (``examples/_bench.py``) against the JAX package's
``bench.py`` and ``examples/`` scripts on the CPU.

* ``flops_per_block`` against XLA's ``cost_analysis()`` of the JAX folded
  pipeline in bf16 on ``bench._build_models``: within 5% (the port counts the
  products with valid taps only; XLA also counts every elementwise op).
* ``_build_models`` gives the state dicts that the JAX ``_build_models``
  trees carry across to; the seeded blocks and superblocks are ``bench.py``'s
  bit for bit; ``bench_tree_cascade``'s ``predict_partition_trees`` at a
  batch of 64 x n gives the trees of ``bench.py``'s own cascade with stub
  predictors, one predict a level.
* Both scripts: the JAX scripts' grid and defaults, a run on the CPU, a
  FAILED row for an out-of-memory error only (every other error propagates:
  ROADMAP F12 is not copied).
"""
import argparse
import ast
import inspect
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from av1tpu.codec import tree as jax_tree
from av1tpu.eval import make_v6_pipeline_folded as jax_folded
from av1tpu_torch.codec.tree import LEVEL_SIZES
from av1tpu_torch.eval import predict_partition_trees
from av1tpu_torch.examples import _bench
from av1tpu_torch.examples import cascade_batch_sweep as port_cascade
from av1tpu_torch.examples import per_size_batch_sweep as port_per_size
from av1tpu_torch.models import from_jax_variables
from tests.test_torch_port_examples import REPO, jax_example
from tests.test_torch_port_tree import _jax_stub, _port_stub

XLA_BATCH = 64
FLOPS_RTOL = 0.05
SCRIPTS = {"per_size_batch_sweep": port_per_size, "cascade_batch_sweep": port_cascade}


@pytest.fixture(scope="module")
def jax_models():
    return bench._build_models(jnp.bfloat16)


@pytest.fixture(scope="module")
def port_models():
    return _bench._build_models("cpu")


def xla_flops_per_block(models, px: int) -> float:
    """What ``bench._time_predict`` reads: the compiled folded pipeline's
    ``cost_analysis()["flops"]`` over the batch."""
    predict = jax_folded(models, stage1_threshold=0.45, float_dtype=jnp.bfloat16)
    images = jax.ShapeDtypeStruct((XLA_BATCH, px, px, 1), jnp.uint16)
    cost = jax.jit(predict).lower(images).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost["flops"]) / XLA_BATCH


# ---------------------------------------------------------------------------
# The bench helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("px", [8, 64])
def test_flops_per_block_within_five_percent_of_xla(jax_models, px):
    """8 and 64 px are the two ends of the padding logic: at 8 px layers 2-4
    run at a 1x1 extent (one valid tap of nine), at 64 px the stem's and
    every layer's windows overhang only the border."""
    want = xla_flops_per_block(jax_models, px)
    got = _bench.flops_per_block(px)
    print(f"{px} px: {got} against XLA's {want:.0f}, {1 - got / want:.2%} under")
    assert abs(got / want - 1) < FLOPS_RTOL, (px, got, want)
    assert got < want  # XLA adds the elementwise ops


def test_build_models_matches_the_bench_trees(jax_models, port_models):
    """Keys and shapes of each stage equal what ``from_jax_variables`` makes
    of the JAX ``_build_models`` variables; the weights are drawn (not zero)
    and fp32, as ``bench.py``'s flax parameters (a pipeline casts after
    folding); these models' layers give ``flops_per_block``'s count."""
    jax_vars = (jax_models.stage1_vars, jax_models.stage2_vars,
                jax_models.stage3_rect_vars, jax_models.stage3_ab_vars)
    port = (port_models.stage1, port_models.stage2, port_models.stage3_rect,
            port_models.stage3_ab)
    for variables, model in zip(jax_vars, port):
        want = {k: tuple(v.shape) for k, v in from_jax_variables(variables).items()}
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want
        assert {t.dtype for t in model.state_dict().values()
                if t.is_floating_point()} == {torch.float32}
        assert float(model.backbone.conv1.weight.detach().float().abs().sum()) > 0
    for px in LEVEL_SIZES:
        assert sum(_bench._stage_flops(m, px) for m in port) == _bench.flops_per_block(px)


def test_backbone_flops_count_valid_taps_only():
    """The parts the kernels' bounds read: at 16 px the 7x7/2 stem's 8 outputs
    a row take 50 of their 56 taps inside the block and layer 1's 3x3 convs
    at extent 4 take 10 of 12; at 8 px layer 2's stride-2 conv1 takes 2 of
    its 3 taps a row at input extent 2 (XLA's (0, 1) padding), and the convs
    at extent 1 their centre tap. The parts and the head make a stage."""
    parts = _bench.backbone_flops(16)
    assert parts["stem"] == 2 * 1 * 64 * 50 ** 2
    assert parts["layer1"] == 4 * 2 * 64 * 64 * 10 ** 2
    assert parts["se1"] == 2 * 2 * 64 * 4
    at8 = _bench.backbone_flops(8)
    assert at8["layer2"] == 2 * 128 * (64 * 2 ** 2 + 3 * 128 * 1 + 64)
    stage1 = _bench._v6_stages()[0]
    for px in LEVEL_SIZES:
        assert sum(_bench.backbone_flops(px).values()) + _bench._dense_flops(
            stage1.head.head) == _bench._stage_flops(stage1, px)


def test_time_predict_defaults_to_bench_timed_iters():
    """The port's ``_time_predict`` times as many calls as ``bench.py``'s
    when the caller names no count (F13)."""
    assert _bench.TIMED_ITERS == bench.TIMED_ITERS
    assert _bench.WARMUP_ITERS == bench.WARMUP_ITERS
    default = inspect.signature(_bench._time_predict).parameters["iters"].default
    assert default == inspect.signature(bench._time_predict).parameters["iters"].default
    assert default == bench.TIMED_ITERS


class _Recorded(Exception):
    pass


@pytest.mark.parametrize("batch, px", [(5, 8), (3, 64)])
def test_seeded_blocks_equal_bench(monkeypatch, batch, px):
    seen = []

    def record(fn, *args):
        seen.append(np.asarray(args[0]))
        raise _Recorded

    monkeypatch.setattr(bench, "_aot_or_jit", record)
    with pytest.raises(_Recorded):
        bench._time_predict(_jax_stub, batch, px)
    got = _bench.seeded_blocks(batch, px)
    assert got.dtype == seen[0].dtype == np.uint16
    np.testing.assert_array_equal(got, seen[0])


@pytest.mark.parametrize("n", [1, 4])
def test_seeded_superblocks_equal_bench(monkeypatch, n):
    seen = []

    def record(fn, *args):
        seen.append(np.asarray(args[0]))
        raise _Recorded

    monkeypatch.setattr(bench, "_aot_or_jit", record)
    with pytest.raises(_Recorded):
        bench.bench_tree_cascade(None, None, n_superblocks=n, predict=_jax_stub)
    got = _bench.seeded_superblocks(n)
    assert got.dtype == seen[0].dtype == np.uint16 and got.shape == (n, 64, 64)
    np.testing.assert_array_equal(got, seen[0])


def test_tree_cascade_equals_the_bench_cascade(monkeypatch):
    """``bench.bench_tree_cascade`` itself, with the stub predictors of
    ``test_torch_port_tree.py`` at every level; its last trees are read out of
    its jitted ``assemble_trees``. The port's cascade is
    ``predict_partition_trees`` at ``bench_tree_cascade``'s batch of 64 x n."""
    n = 16
    captured = []
    original = jax_tree.assemble_trees

    def assemble(level_modes):
        trees = original(level_modes)
        jax.debug.callback(lambda t: captured.append(np.asarray(t)), trees)
        return trees

    monkeypatch.setattr(jax_tree, "assemble_trees", assemble)
    bench.bench_tree_cascade(None, None, n_superblocks=n, iters=1,
                             predict_by_size=dict.fromkeys(LEVEL_SIZES, _jax_stub))
    want = captured[-1]
    sbs = torch.from_numpy(_bench.seeded_superblocks(n))
    got = predict_partition_trees(sbs, dict.fromkeys(LEVEL_SIZES, _port_stub),
                                  batch_size=64 * n, as_numpy=False, device="cpu")["trees"]
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 21:] >= 0).any() and (want[:, 1:] < 0).any()


@pytest.mark.parametrize("n", [3, 16])
def test_tree_cascade_is_one_predict_a_level(n):
    """``bench_tree_cascade`` calls each level's predictor once a cascade, on
    all of the level's rows (n, 4n, 16n, 64n), as ``bench.py`` does."""
    calls = []

    def stub(size):
        def predict(images):
            calls.append((size, tuple(images.shape)))
            return _port_stub(images)
        return predict

    _bench.bench_tree_cascade(None, torch.bfloat16, n_superblocks=n, iters=2,
                              predict_by_size={size: stub(size) for size in LEVEL_SIZES},
                              device="cpu")
    one = [(size, (n * (64 // size) ** 2, size, size, 1)) for size in LEVEL_SIZES]
    assert calls == one * (_bench.WARMUP_ITERS + 2)


def test_helpers_time_on_the_cpu_without_an_mfu():
    calls = []

    def predict(images):
        calls.append((images.dtype, tuple(images.shape)))
        return _port_stub(images)

    rate, flops, mfu = _bench._time_predict(predict, 6, 16, iters=2, device="cpu")
    assert calls == [(torch.uint16, (6, 16, 16, 1))] * (_bench.WARMUP_ITERS + 2)
    assert rate > 0 and flops == _bench.flops_per_block(16) and mfu is None
    out = _bench.bench_tree_cascade(None, torch.bfloat16, n_superblocks=3, iters=1,
                                    predict_by_size=dict.fromkeys(LEVEL_SIZES, _port_stub),
                                    device="cpu")
    assert sorted(out) == ["mfu", "superblocks_per_dispatch", "trees_per_sec"]
    assert out["trees_per_sec"] > 0 and out["mfu"] is None
    assert out["superblocks_per_dispatch"] == 3
    assert _bench.mfu_cell(None) == "not measured" and _bench.mfu_cell(0.0234) == "2.3%"
    assert _bench.describe_device("cpu") == "device: cpu"


# ---------------------------------------------------------------------------
# The scripts
# ---------------------------------------------------------------------------


def _jax_literals(name: str) -> dict:
    """The JAX script's argparse defaults, its ``sweep`` grid (if any) and the
    table's header lines, read from its source."""
    source = (REPO / "examples" / f"{name}.py").read_text()
    out = {"defaults": {}, "headers": []}
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flag = node.args[0].value.lstrip("-")
            out["defaults"][flag] = next(ast.literal_eval(k.value) for k in node.keywords
                                         if k.arg == "default")
        elif isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "sweep":
            out["sweep"] = ast.literal_eval(node.value)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("|") and node.value.endswith("|"):
            out["headers"].append(node.value)
    return out


def _port_defaults(module) -> dict:
    seen = []
    original = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        seen.append(original(self, ["--device", "cpu"]))
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(SystemExit):
            module.main([])
    return vars(seen[0])


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_grid_and_defaults_equal_the_jax_script(name):
    want = _jax_literals(name)
    got = _port_defaults(SCRIPTS[name])
    assert {k: got[k] for k in want["defaults"]} == want["defaults"]
    assert got["device"] == "cpu" and set(got) == set(want["defaults"]) | {"device"}
    if name == "per_size_batch_sweep":
        assert port_per_size.SWEEP == want["sweep"]
    assert len(want["headers"]) == 2


@pytest.fixture
def quick(monkeypatch, port_models):
    """One warm-up call, and the module fixture's models in place of a fresh
    ``_build_models``."""
    monkeypatch.setattr(_bench, "WARMUP_ITERS", 1)
    for module in SCRIPTS.values():
        monkeypatch.setattr(module, "_build_models", lambda device: port_models)


def _table(printed: str) -> list:
    return [[c.strip() for c in line.strip("|").split("|")]
            for line in printed.splitlines() if line.startswith("| ") and line[2].isdigit()]


def test_per_size_sweep_runs_on_the_cpu(monkeypatch, capsys, quick):
    monkeypatch.setattr(port_per_size, "SWEEP", {8: (2, 3), 16: (2,)})
    port_per_size.main(["--sizes", "16", "8", "--iters", "1", "--device", "cpu"])
    printed = capsys.readouterr().out
    lines = printed.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1:3] == _jax_literals("per_size_batch_sweep")["headers"]
    rows = _table(printed)
    assert [r[:2] for r in rows] == [["16", "2"], ["8", "2"], ["8", "3"]]
    assert all(float(r[2].replace(",", "")) > 0 and r[3] == "not measured" for r in rows)
    best = ast.literal_eval(printed[printed.rindex("best:") + 5:].strip())
    assert sorted(best) == [8, 16] and best[16]["batch"] == 2 and best[8]["mfu"] is None


def test_cascade_sweep_runs_on_the_cpu(capsys, quick):
    port_cascade.main(["--n", "2", "3", "--iters", "1", "--device", "cpu"])
    printed = capsys.readouterr().out
    lines = printed.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1:3] == _jax_literals("cascade_batch_sweep")["headers"]
    rows = _table(printed)
    assert [r[0] for r in rows] == ["2", "3"] and all(r[2] == "not measured" for r in rows)
    best = json.loads(printed[printed.rindex("best:") + 5:])
    assert best["superblocks_per_dispatch"] in (2, 3) and best["mfu"] is None


def _fail_at(module, monkeypatch, at, exc):
    """Make the timed helper of ``module`` raise ``exc`` at one grid point."""
    if module is port_per_size:
        def fake(predict, batch, px, iters, device):
            if batch == at:
                raise exc
            return 100.0 * batch, 1, None
        monkeypatch.setattr(port_per_size, "_time_predict", fake)
        return ["--sizes", "8", "--iters", "1", "--device", "cpu"]

    def fake(models, dtype, n_superblocks, iters, device):
        if n_superblocks == at:
            raise exc
        return {"trees_per_sec": 10.0 * n_superblocks, "mfu": None,
                "superblocks_per_dispatch": n_superblocks}
    monkeypatch.setattr(port_cascade, "bench_tree_cascade", fake)
    return ["--n", "2", "3", "4", "--iters", "1", "--device", "cpu"]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_out_of_memory_gives_a_failed_row_and_the_sweep_goes_on(monkeypatch, capsys, quick,
                                                                name):
    module = SCRIPTS[name]
    if module is port_per_size:
        monkeypatch.setattr(port_per_size, "SWEEP", {8: (2, 3, 4)})
    argv = _fail_at(module, monkeypatch, 3,
                    torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)"))
    module.main(argv)
    printed = capsys.readouterr().out
    rows = _table(printed)
    assert len(rows) == 3
    failed = [r for r in rows if r[-2].startswith("FAILED")]
    assert len(failed) == 1 and failed[0][-2] == "FAILED: OutOfMemoryError"
    assert failed[0][-1] == "" and "3" in failed[0][:-2]
    assert "best:" in printed and "FAILED" not in printed[printed.rindex("best:"):]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_every_other_error_propagates(monkeypatch, quick, name):
    """F12: the JAX per-size sweep unpacks three of ``_time_predict``'s four
    values and its catch-all prints the ``ValueError`` as a FAILED row. Here
    it stops the sweep."""
    module = SCRIPTS[name]
    if module is port_per_size:
        monkeypatch.setattr(port_per_size, "SWEEP", {8: (2, 3)})
    argv = _fail_at(module, monkeypatch, 2, ValueError("not an out-of-memory error"))
    with pytest.raises(ValueError, match="not an out-of-memory"):
        module.main(argv)


def test_a_four_value_time_predict_is_not_swallowed(monkeypatch, capsys, jax_models, quick):
    """F12 itself: ``bench._time_predict`` returns four values. The JAX script
    unpacks three and prints every row FAILED; the port's raises."""
    four = (1.0, 2, None, "aot_err")
    monkeypatch.setattr(bench, "_build_models", lambda dtype: jax_models)
    monkeypatch.setattr(bench, "_time_predict", lambda *a, **k: four)
    monkeypatch.setattr(sys, "argv", ["per_size_batch_sweep.py", "--sizes", "8"])
    jax_example("per_size_batch_sweep").main()
    rows = _table(capsys.readouterr().out)
    assert len(rows) == 4 and all(r[2] == "FAILED: ValueError" for r in rows)

    monkeypatch.setattr(port_per_size, "SWEEP", {8: (2,)})
    monkeypatch.setattr(port_per_size, "_time_predict", lambda *a, **k: four)
    with pytest.raises(ValueError, match="too many values to unpack"):
        port_per_size.main(["--sizes", "8", "--device", "cpu"])


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_device_cuda_without_a_card_is_a_parser_error(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as refused:
        SCRIPTS[name].main(["--device", "cuda"])
    assert refused.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
