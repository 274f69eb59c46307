"""The plain reference against the port, on the CPU, at small sizes: the
same seeded weights through the port's own modules and folded pipelines give
the reference's logits, decisions and trees."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from av1tpu_torch.eval.tree_infer import predict_frame_trees
from av1tpu_torch.ingest.tiler import tile_frame
from portbench import spec, system
from portbench.data import frame
from portbench.reference import cascade as ref
from portbench.weights import make_level_models

CPU = torch.device("cpu")


def _level_models(family, config, levels, seed=5):
    gen = torch.Generator().manual_seed(seed)
    calib = {}
    for px in levels:
        calib[px] = frame(gen, 8 * px, 8 * px, CPU).reshape(8, px, 8, px)
        calib[px] = calib[px].transpose(0, 2, 1, 3).reshape(-1, px, px)
    return make_level_models(family, config, calib, gen, CPU), calib


@pytest.mark.parametrize("name", ["v6_stages", "v6_unified"])
@pytest.mark.parametrize("px", [8, 16, 64])
def test_reference_logits_match_the_port_modules(name, px):
    config = spec.load_config(name)
    family = spec.load_family(config["family"])
    models, calib = _level_models(family, config, [px])
    x = torch.from_numpy(calib[px].astype(np.float32))[..., None] / config["norm_scale"]
    with torch.no_grad():
        want = family.reference.level_logits(config["arch"], models[px], x)
        for kind, sd in models[px].items():
            got = system.module(family.port.CLASSES[kind], sd)(x)
            if kind == "unified":
                parts = {"stage1": got[:, 0], "stage2": got[:, 1:4], "rect": got[:, 4:6],
                         "ab": got[:, 6:10]}
            else:
                parts = {kind: got}  # Stage1Model returns (N,) logits
            for head, value in parts.items():
                err = (value - want[head]).abs().max().item()
                assert err <= 1e-4 * max(1.0, want[head].abs().max().item()), (kind, head, err)


@pytest.mark.parametrize("name", ["v6_stages", "v6_unified"])
def test_reference_cascade_matches_the_port_on_a_small_frame(name):
    """fp32 folded pipelines with the configuration's kernel options (their
    plain twins on the CPU) against the reference's frame cascade: every
    mode equal where each decision's margin is above 1e-3, and the trees."""
    config = dict(spec.load_config(name), float_dtype="float32")
    family = spec.load_family(config["family"])
    models, _ = _level_models(family, config, ref.LEVELS)
    plane = frame(torch.Generator().manual_seed(9), 200, 136, CPU)
    assert np.array_equal(tile_frame(plane, 64)[0], ref.tile_superblocks(plane))
    predictors = system.build_predictors(family, config, models, CPU)
    got = predict_frame_trees(plane, predictors, batch_size=256, device="cpu")
    want = ref.frame_reference(family, config["arch"], models, [plane], config["stage1_threshold"],
                               config["norm_scale"], CPU, {s: 512 for s in ref.LEVELS})
    assert list(got["grid_shape"]) == [3, 4]
    for li, size in enumerate(ref.LEVELS):
        sure = np.stack(list(ref.margins(want["logits"][size],
                                         config["stage1_threshold"]).values())).min(0) > 1e-3
        g, w = got[f"modes_{size}"].reshape(-1), want["modes"][li][0].reshape(-1)
        assert (g == w)[sure].all() and sure.mean() > 0.9
    assert np.array_equal(got["trees"], ref.assemble([got[f"modes_{s}"] for s in ref.LEVELS]))
    assert 1.5 < (got["trees"] >= 0).sum(1).mean() < 85  # the trees vary


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    """The plain reference (``reference/*`` and every family's
    ``reference.py``) imports nothing of the port; of the harness's modules
    only ``system.py`` and the families' ``port.py`` import the port."""
    references = [*(spec.PKG / "reference").glob("*.py"),
                  *(spec.PKG / "families").glob("*/reference.py")]
    assert len(references) >= 4
    for path in references:
        for n in _imports(path):
            assert n.split(".")[0] in ("torch", "numpy", "portbench", "math", "contextlib",
                                       "typing", "__future__"), (path, n)
            assert not n.startswith(("portbench.system", "portbench.run")), (path, n)
    allowed = {spec.PKG / "system.py", *(spec.PKG / "families").glob("*/port.py")}
    harness = [p for p in spec.PKG.rglob("*.py") if spec.PKG / "tests" not in p.parents]
    importing = {p for p in harness
                 if any(n.split(".")[0] in ("av1tpu_torch", "av1tpu") for n in _imports(p))}
    assert importing <= allowed and spec.PKG / "system.py" in importing, importing - allowed
    assert "av1tpu" not in Path(spec.PKG / "weights.py").read_text()
