"""The extension point: a model family made only of two files outside
``portbench/`` runs through a whole cell on the CPU and comes out correct,
and nothing under ``portbench/`` changes.

The family here is the per-stage family with pesquisa_v6's FGVC AB model
(``006_train_stage3_ab_fgvc.py``: the trunk, then two Linear + BatchNorm1d +
ReLU layers, L2 normalisation and a cosine classifier at scale 20), a head
no file of the harness knows. It brings no share calibration for the AB
decision: the cosine classifier has no bias to shift.
"""
import hashlib
import json

import pytest
import torch

from portbench import run, spec
from portbench.tests.test_portbench_run import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 91

REFERENCE = '''
"""Per-stage v6 with the FGVC AB model, in plain PyTorch."""
import torch

from portbench.counts import v6 as counts
from portbench.reference.v6 import backbone, backbone_shapes, head, head_shapes, last_bias

DECISIONS = ("stage1", "stage2", "rect", "ab")
EMBED, CLASSES, SCALE = 512, 4, 20.0


def kinds(config):
    return list(DECISIONS)


def shapes(arch, kind):
    out = backbone_shapes(arch)
    if kind != "ab":
        out += head_shapes(arch["heads"][kind], arch["widths"][-1], "head")
        return out + ([("head.temperature", (1,))] if kind == "stage1" else [])
    width = arch["widths"][-1]
    for i in (0, 4):
        out += [(f"feat_proj.{i}.weight", (EMBED, width)), (f"feat_proj.{i}.bias", (EMBED,))]
        out += [(f"feat_proj.{i + 1}.{k}", (EMBED,))
                for k in ("weight", "bias", "running_mean", "running_var")]
        width = EMBED
    return out + [("classifier.weight", (CLASSES, EMBED))]


def _unit(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def _fgvc(sd, arch, x, calibrate):
    for i in (0, 4):
        x = x @ sd[f"feat_proj.{i}.weight"].T + sd[f"feat_proj.{i}.bias"]
        p = f"feat_proj.{i + 1}"
        if calibrate:
            sd[f"{p}.running_mean"].copy_(x.mean(0))
            sd[f"{p}.running_var"].copy_(x.var(0, unbiased=False))
        x = (x - sd[f"{p}.running_mean"]) / torch.sqrt(sd[f"{p}.running_var"] + arch["bn_eps"])
        x = torch.relu(x * sd[f"{p}.weight"] + sd[f"{p}.bias"])
    return SCALE * _unit(x) @ _unit(sd["classifier.weight"]).T


def level_logits(arch, models, x, calibrate=False):
    out = {}
    for d in DECISIONS:
        feats = backbone(models[d], arch, x, calibrate)
        out[d] = (_fgvc(models[d], arch, feats, calibrate) if d == "ab"
                  else head(models[d], "head", feats))
    out["stage1"] = out["stage1"][:, 0]
    return out


def first_class_shift(models, decision, amount):
    if decision != "ab":  # the cosine classifier has no bias
        last_bias(models[decision], "head")[0] += amount


def trunks(config):
    return 3  # the FGVC trunk runs unfolded, without the fused kernels


def per_block(config, px):
    arch = config["arch"]
    trunk = sum(counts.backbone(arch, px).values())
    heads = sum(counts.head(arch["heads"][d], arch["widths"][-1]) for d in DECISIONS[:3])
    return 4 * trunk + heads + counts.head([EMBED, EMBED, CLASSES], arch["widths"][-1])
'''

PORT = '''
"""The port's per-stage predictor with the FGVC AB model."""
from av1tpu_torch.eval.folded import make_v6_pipeline_folded
from av1tpu_torch.eval.hierarchy import PipelineModels
from av1tpu_torch.models.fgvc import FGVCModel
from av1tpu_torch.models.v6 import Stage1Model, Stage2Model, Stage3RectModel
from portbench.system import DTYPES, module

CLASSES = {"stage1": Stage1Model, "stage2": Stage2Model, "rect": Stage3RectModel,
           "ab": FGVCModel}


def build(config, models, device, calib=None):
    stages = PipelineModels(*(module(cls, models[kind]) for kind, cls in CLASSES.items()))
    return make_v6_pipeline_folded(
        stages, config["stage1_threshold"], config["norm_scale"],
        float_dtype=DTYPES[config["float_dtype"]], use_fused_front=config["use_fused_front"],
        device=device, use_pallas_groups=config["use_pallas_groups"])
'''


def _files(root):
    """Every file under ``root`` but bytecode, with a digest of its bytes."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and p.suffix != ".pyc"}


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["v6_stages.offline_1080p", "v6_stages.blocks_16px"])
def test_a_family_of_two_files_elsewhere_runs_to_correct(tmp_path, cell):
    before = _files(spec.PKG)
    (tmp_path / "stages_fgvc").mkdir()
    (tmp_path / "stages_fgvc" / "reference.py").write_text(REFERENCE)
    (tmp_path / "stages_fgvc" / "port.py").write_text(PORT)
    family = spec.load_family("stages_fgvc", directory=tmp_path)
    config = dict(spec.load_config("v6_stages"), name="v6_fgvc", family="stages_fgvc")
    result = run.run_cell(cell, SEED, 0.2, False, CPU, config=config, traffic=tiny(cell),
                          family=family)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    assert _files(spec.PKG) == before
