"""Shared CLI plumbing: dataset splits, checkpoint and model loading (npz
or a reference ``.pt``), one model's outputs over a split, the int8
calibration subsample, the trainers' common flags and outputs, the mesh
of a world of processes (``torchrun``; rank 0 prints and writes), and the
PNGs that are skipped where matplotlib is not installed.

Dataset bundles are ``av1tpu_torch.data.bundles``, the port's own copy of
the JAX package's format (same npz keys and ``metadata.json``)."""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from av1tpu_torch.data.bundles import Bundle
from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.hierarchy import on_device, run_pipeline_batched
from av1tpu_torch.eval.plots import plot_training_curves
from av1tpu_torch.models.jax_import import load_jax_variables
from av1tpu_torch.models.torch_import import import_any, load_torch_checkpoint
from av1tpu_torch.parallel.mesh import (
    default_mesh,
    init_from_env,
    is_writer,
    make_mesh,
    world_size,
)
from av1tpu_torch.train.checkpoint import load_variables_npz, save_variables_npz
from av1tpu_torch.train.stages import variables_of


def load_split(dataset_dir: Path, block_size: int) -> Tuple[Bundle, Bundle, Dict]:
    """``<dir>/block_<S>/{train,val}.npz`` and its metadata."""
    root = Path(dataset_dir) / f"block_{block_size}"
    train = Bundle.load(root / "train.npz")
    val = Bundle.load(root / "val.npz")
    meta_path = root / "metadata.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return train, val, meta


def load_model_variables(path: Path) -> Dict[str, Any]:
    """Load a JAX variable tree from a flat npz checkpoint, or import a
    reference torch ``.pt``/``.pth``: its state dict goes to the importer
    its key shape names (v5 hierarchical, FGVC or a v6 stage model,
    ``models.torch_import.import_any``) and comes back as the JAX package's
    float32 numpy tree."""
    path = Path(path)
    if path.suffix == ".npz":
        return load_variables_npz(path)
    if path.suffix in (".pt", ".pth"):
        return _as_float32(import_any(load_torch_checkpoint(path)))
    raise ValueError(f"unsupported checkpoint format: {path}")


def _as_float32(tree):
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def load_model(path: Path, model_cls) -> nn.Module:
    """``model_cls()`` holding the checkpoint at ``path`` (npz or ``.pt``), in
    eval mode (an FGVC checkpoint's class ``centers`` are training state and
    dropped)."""
    variables = load_model_variables(path)
    variables.pop("centers", None)
    return load_jax_variables(model_cls(), variables).eval()


def model_outputs(model: nn.Module, head: Callable, samples: np.ndarray,
                  batch_size: int, device, dtype) -> np.ndarray:
    """``head(model, x)`` over uint16 NHWC ``samples`` divided by 1023, in
    batches on ``device`` with the model cast to ``dtype``, as numpy."""
    model = on_device(model, device, dtype)

    @torch.inference_mode()
    def predict(images):
        x = (images.to(torch.float32) / NORM_10BIT).to(dtype)
        return {"out": head(model, x)}

    return run_pipeline_batched(predict, samples, batch_size, device)["out"]


def train_calibration_blocks(train_samples: np.ndarray, n: int) -> np.ndarray:
    """The int8 calibration blocks of the JAX CLIs: ``min(n, len)`` rows of
    the train split drawn without replacement by ``default_rng(0)``, in row
    order."""
    idx = np.random.default_rng(0).choice(
        len(train_samples), size=min(n, len(train_samples)), replace=False)
    return train_samples[np.sort(idx)]


def add_common_train_args(parser: argparse.ArgumentParser) -> None:
    """The JAX trainers' common flags, and ``--device``."""
    parser.add_argument("--dataset-dir", type=Path, required=True,
                        help="directory containing block_<S>/{train,val}.npz")
    parser.add_argument("--block-size", type=int, default=16, choices=(8, 16, 32, 64))
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--bf16", action="store_true",
                        help="forward under bfloat16 autocast (fp32 parameters, "
                        "BN statistics and loss)")
    parser.add_argument("--num-model-shards", type=int, default=1,
                        help="model-axis size of the device mesh over the world's "
                        "processes (torchrun): the wide layers' output channels "
                        "split over that many ranks, the batch over the rest")
    parser.add_argument("--resume", type=Path, default=None,
                        help="checkpoint dir (…_last/…_best/…_final) to resume from")
    parser.add_argument("--checkpoint-every", type=int, default=10,
                        help="epochs between rolling resume anchors; epochs "
                        "replay deterministically so a sparse anchor costs "
                        "recovery time, never correctness")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")


def check_train_args(parser: argparse.ArgumentParser, args) -> None:
    """Refuse what the port's trainers do not run, then join the world of
    processes that ``torchrun`` started (nothing in a world of one)."""
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    if args.num_model_shards < 1:
        parser.error("--num-model-shards must be at least 1")
    init_from_env(args.device)
    if world_size() % args.num_model_shards:
        parser.error(f"--num-model-shards {args.num_model_shards} does not divide the "
                     f"world of {world_size()} processes")


def make_cli_mesh(num_model_shards: int = 1):
    """The trainers' mesh: ``None`` in a world of one process with one model
    shard (no collectives at all), else a ``(data, model)`` mesh over the
    world with ``num_model_shards`` on the model axis."""
    if world_size() == 1 and num_model_shards == 1:
        return None
    return make_mesh(num_model=num_model_shards)


def serving_mesh(args):
    """The serving CLIs' mesh: join the ``torchrun`` world, then ``None``
    with ``--single-device`` or in a world of one, else a data-parallel mesh
    over every process (the JAX CLIs' ``default_mesh()``)."""
    init_from_env(args.device)
    mesh = None if args.single_device else default_mesh()
    if mesh is not None:
        cli_log(f"sharding inference over mesh {{'data': {world_size()}, 'model': 1}}")
    return mesh


def cli_log(message: str) -> None:
    """Print on rank 0 only (every line once in a world of processes)."""
    if is_writer():
        print(message)


def add_single_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--single-device", action="store_true",
                        help="no mesh: serve on this process's device alone "
                        "(default: shard the batches over every torchrun process)")


def export_best(result, model_name: str, output_dir: Path) -> Optional[Path]:
    """The best state's model variables as a flat npz in the JAX key layout
    (``<name>_best_variables.npz``), which both packages serve. Written
    uncompressed, as every variables file of the port's trainer: fp32
    weights barely compress, and zlib takes seconds a file."""
    if result.best_state is None:
        return None
    return save_variables_npz(Path(output_dir) / f"{model_name}_best_variables.npz",
                              variables_of(result.best_state.model), compress=False)


def save_plot(draw: Callable[[Path], Any], path: Path) -> None:
    """``draw(path)`` writes a PNG (a function of ``eval.plots``). Where
    matplotlib does not import, print one line saying so and go on: the
    CLIs that draw serve and train without it."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"{path.name} not written: matplotlib is not installed")
        return
    draw(path)


def write_history(result, output_dir: Path, name: str) -> None:
    """``<name>_history.json``, ``<name>_training_curves.png`` and
    ``<name>_summary.json``, as the JAX CLIs write them (rank 0 only)."""
    if not is_writer():
        return
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    result.save_history(out / f"{name}_history.json")
    if result.history:
        save_plot(lambda path: plot_training_curves(result.history, path),
                  out / f"{name}_training_curves.png")
    (out / f"{name}_summary.json").write_text(json.dumps({
        "best_value": result.best_value,
        "epochs": len(result.history),
        "final_val_metrics": result.history[-1]["val_metrics"] if result.history else None,
    }, indent=2))


__all__ = ["add_common_train_args", "add_single_device_arg", "check_train_args",
           "cli_log", "export_best", "load_model", "load_model_variables", "load_split",
           "make_cli_mesh", "model_outputs", "save_plot", "serving_mesh",
           "train_calibration_blocks", "write_history"]
