"""Shared helpers of the port's parity tests (``test_torch_port_*.py``).

Weights are flax inits whose BatchNorm running stats are first set to the
batch statistics of a calibration batch and then perturbed, so that every
layer sees unit-scale activations and the logits depend on the input (the
F2 guard of ROADMAP Queue 3). Inputs come from numpy seeds. The cascade
tests need sixteen models (four stages at four block sizes): those are drawn
and calibrated in torch (:func:`cascade_stage_models`, no jax compile) and
carried to the JAX package through ``to_jax_variables``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from av1tpu import models as jm
from av1tpu.codec.partitions import map_to_stage2_v6
from av1tpu.data.bundles import Bundle, save_split
from av1tpu.utils.initialization import init_on_cpu
from av1tpu_torch import models as tm
from av1tpu_torch.models import to_jax_variables
from av1tpu_torch.train.checkpoint import save_variables_npz
from chip_smoke import seeded_model, set_first_class_share, structured_luma

STAGE1_THRESHOLD = 0.45
LEVEL_SIZES = (64, 32, 16, 8)
STAGE_CLASSES = {  # name -> (flax class, port class)
    "stage1": (jm.Stage1Model, tm.Stage1Model),
    "stage2": (jm.Stage2Model, tm.Stage2Model),
    "rect": (jm.Stage3RectModel, tm.Stage3RectModel),
    "ab": (jm.Stage3ABModel, tm.Stage3ABModel),
}
# The share of probe blocks on which a cascade model takes its first decision:
# the gate opens and stage 2 says SPLIT (its class 0) on most blocks but not
# all, so that trees reach every level and stop at every level.
FIRST_CLASS_SHARE = {"stage1": 0.85, "stage2": 0.65, "rect": 0.5, "ab": 0.35}
MOMENTUM = 0.9  # flax BatchNorm default


def images_u16(seed: int, n: int, hw: int) -> np.ndarray:
    """Uniform 10-bit luma blocks, NHWC uint16."""
    return np.random.default_rng(seed).integers(
        0, 1024, size=(n, hw, hw, 1), dtype=np.uint16
    )


def calibrated_variables(model, seed: int, hw: int, n: int = 128):
    """Flax init of ``model`` with BN running stats = calibration-batch
    stats, then mean shifted by N(0, 0.2)*std and var scaled by U(0.5, 1.5)."""
    x = images_u16(1000 + seed, n, hw).astype(np.float32) / 1023.0
    v = init_on_cpu(model, jax.random.PRNGKey(seed), jnp.zeros((2, hw, hw, 1)))
    _, upd = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(seed)},
    ))(v, x)
    # running = m*old + (1-m)*batch  =>  batch = (running - m*old) / (1-m)
    batch = jax.tree_util.tree_map(
        lambda old, new: (np.asarray(new) - MOMENTUM * old) / (1 - MOMENTUM),
        v["batch_stats"], upd["batch_stats"],
    )
    rng = np.random.default_rng(seed)

    def perturb(node):
        if "mean" in node and "var" in node:
            var = np.maximum(node["var"], 1e-3)
            return {
                "mean": (node["mean"] + rng.normal(0, 0.2, var.shape)
                         * np.sqrt(var)).astype(np.float32),
                "var": (var * rng.uniform(0.5, 1.5, var.shape)).astype(np.float32),
            }
        return {k: perturb(val) for k, val in node.items()}

    return {"params": v["params"], "batch_stats": perturb(batch)}


def superblocks_u16(seed: int, n: int) -> np.ndarray:
    """``(n, 64, 64)`` uint16 luma superblocks with structure at every scale
    of the 64->32->16->8 hierarchy (``chip_smoke.structured_luma``)."""
    return structured_luma(np.random.default_rng(seed), (n, 64, 64))


def blocks_of_every_size(sbs: np.ndarray) -> dict:
    """``{size: (N, size, size, 1)}``: every aligned 64/32/16/8 px block of
    ``(n, 64, 64)`` superblocks (row-major; the order does not matter here)."""
    out = {}
    for size in (64, 32, 16, 8):
        f = 64 // size
        out[size] = (sbs.reshape(-1, f, size, f, size).transpose(0, 1, 3, 2, 4)
                     .reshape(-1, size, size, 1))
    return out


def seeded_torch_model(cls, seed: int, calib_u16: np.ndarray):
    """A port model drawn from ``seed`` whose BN running stats are those of
    ``calib_u16`` (uint16 NHWC blocks of the size it will serve), perturbed:
    ``chip_smoke.seeded_model``, the twin of :func:`calibrated_variables`
    that needs no jax compile. Carry it to the JAX package with
    :func:`jax_variables`."""
    torch.manual_seed(seed)  # dropout during the calibration forward
    calib = torch.from_numpy(calib_u16.astype(np.float32) / 1023.0)
    return seeded_model(cls, torch.Generator().manual_seed(seed), calib)


def jax_variables(model) -> dict:
    """The JAX package's ``{"params", "batch_stats"}`` tree of a port model."""
    return to_jax_variables(model.state_dict())


def _as_input(blocks_u16: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(blocks_u16.astype(np.float32) / 1023.0)


def cascade_stage_models(seed: int, sizes=LEVEL_SIZES) -> dict:
    """``{size: {name: port model}}``: the stage models of each level of the
    cascade, each calibrated on blocks of its own size (a random ResNet
    calibrated at one size saturates or dies at another), every head shifted to
    ``FIRST_CLASS_SHARE`` on probe blocks. Every model
    passes the F2 guard."""
    calib = blocks_of_every_size(superblocks_u16(seed, 16))
    probe = blocks_of_every_size(superblocks_u16(seed + 1, 48))
    out = {}
    for size in sizes:
        x = _as_input(probe[size][:256])
        out[size] = {}
        for i, name in enumerate(STAGE_CLASSES):
            model = seeded_torch_model(STAGE_CLASSES[name][1], seed + size + i,
                                       calib[size][:128])
            with torch.no_grad():
                logits = model(x).numpy()
            logits = set_first_class_share(model.head, logits, FIRST_CLASS_SHARE[name])
            assert_input_sensitive(logits, 1e-4)
            out[size][name] = model
    return out


def cascade_unified_models(seed: int) -> dict:
    """``{size: UnifiedV6Model}``, the single-trunk twin of
    :func:`cascade_stage_models`."""
    calib = blocks_of_every_size(superblocks_u16(seed, 16))
    probe = blocks_of_every_size(superblocks_u16(seed + 1, 48))
    out = {}
    for size in LEVEL_SIZES:
        model = seeded_torch_model(tm.UnifiedV6Model, seed + size, calib[size][:128])
        with torch.no_grad():
            logits = model(_as_input(probe[size][:256])).numpy()
        for name, (lo, hi) in tm.UNIFIED_LOGIT_SLICES.items():
            part = logits[:, lo] if name == "stage1" else logits[:, lo:hi]
            part = set_first_class_share(getattr(model, f"head_{name}"), part,
                                         FIRST_CLASS_SHARE[name])
            assert_input_sensitive(part, 1e-4)
        out[size] = model
    return out


def assert_input_sensitive(logits: np.ndarray, tol: float) -> None:
    """F2 guard: at least two distinct decisions, and a logit spread far
    above the tolerance a parity check then uses."""
    logits = np.asarray(logits, np.float64)
    if logits.ndim == 1:  # stage-1 gate: decisions are the two gate sides
        decisions = 1 / (1 + np.exp(-logits)) >= STAGE1_THRESHOLD
    else:
        decisions = logits.argmax(-1)
    assert len(np.unique(decisions)) >= 2, "every input gets the same decision"
    spread = logits.std(axis=0).min()
    assert spread >= 100 * tol, f"logit std {spread} < 100 x {tol}"


def top2_margin(logits: np.ndarray) -> np.ndarray:
    """Per-sample gap between the two largest logits."""
    top = np.sort(np.asarray(logits), axis=-1)
    return top[:, -1] - top[:, -2]


# The CLI parity tests' checkpoints: name -> (flax class, port class, seed)
CLI_MODELS = {
    "stage1": (jm.Stage1Model, tm.Stage1Model, 90),
    "stage2": (jm.Stage2Model, tm.Stage2Model, 91),
    "rect": (jm.Stage3RectModel, tm.Stage3RectModel, 98),
    "ab": (jm.Stage3ABModel, tm.Stage3ABModel, 93),
    "fgvc": (jm.FGVCModel, tm.FGVCModel, 94),
}


def cli_bundle(seed: int, n: int) -> Bundle:
    """A 16 px v6 split of ``n`` uniform blocks with random raw labels and
    the stage-1 and stage-2 views the CLIs read."""
    stage0 = np.random.default_rng(seed).integers(0, 10, size=n).astype(np.int32)
    return Bundle(samples=images_u16(seed, n, 16), qps=np.full(n, 90, np.int32),
                  labels={"stage0": stage0,
                          "stage1": (stage0 != 0).astype(np.int32),
                          "stage2": map_to_stage2_v6(stage0)[0].astype(np.int32)})


def cli_workspace(root: Path, n_val: int = 1024, names=tuple(CLI_MODELS)) -> dict:
    """What the CLI parity tests share: a 16 px dataset (64 train, ``n_val``
    val blocks) under ``root/dataset``, one npz checkpoint per
    :data:`CLI_MODELS` entry in ``names`` (uncompressed: random weights do not
    compress, and every CLI run loads them), the port models holding the
    same weights, and
    each model's decision margins on the val blocks (``stage1``: distance of
    the probability from :data:`STAGE1_THRESHOLD`; the others: top-2 logit
    gap). Every model passes the F2 guard on the val blocks."""
    dataset = root / "dataset"
    save_split(dataset, 16, cli_bundle(95, 64), cli_bundle(96, n_val), "v6")
    ckpts, port, variables = {}, {}, {}
    for name in names:
        jcls, tcls, seed = CLI_MODELS[name]
        variables[name] = calibrated_variables(jcls(), seed, 16)
        ckpts[name] = save_variables_npz(root / f"{name}_variables.npz", variables[name],
                                         compress=False)
        port[name] = tm.load_jax_variables(tcls(), variables[name]).eval()
    val = Bundle.load(dataset / "block_16" / "val.npz")
    with torch.no_grad():
        x = torch.from_numpy(val.samples.astype(np.float32) / 1023.0)
        logits = {name: m(x).numpy() for name, m in port.items()}
    for lg in logits.values():
        assert_input_sensitive(lg, 1e-4)
    s1 = 1 / (1 + np.exp(-logits["stage1"].astype(np.float64)))
    margins = {name: top2_margin(lg) for name, lg in logits.items() if name != "stage1"}
    margins["stage1"] = np.abs(s1 - STAGE1_THRESHOLD)
    return {"root": root, "dataset": dataset, "ckpts": ckpts, "port": port,
            "variables": variables, "val": val, "margins": margins}


def cli_argv(dataset, ckpts, out, fgvc: bool, extra) -> list:
    """``run_pipeline_eval`` arguments of both packages for the v6 variant on
    :func:`cli_workspace`'s files, fp32, batch 384."""
    return [
        "--variant", "v6", "--dataset-dir", str(dataset), "--block-size", "16",
        "--output-dir", str(out), "--batch-size", "384",
        "--stage1-threshold", str(STAGE1_THRESHOLD),
        "--stage1-checkpoint", str(ckpts["stage1"]),
        "--stage2-checkpoint", str(ckpts["stage2"]),
        "--stage3-rect-checkpoint", str(ckpts["rect"]),
        "--stage3-ab-checkpoint", str(ckpts["fgvc" if fgvc else "ab"]),
        "--ab-fgvc" if fgvc else "--no-ab-fgvc", *extra,
    ]
