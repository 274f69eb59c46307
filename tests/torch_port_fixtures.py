"""Shared helpers of the port's parity tests (``test_torch_port_*.py``).

Weights are flax inits whose BatchNorm running stats are first set to the
batch statistics of a calibration batch and then perturbed, so that every
layer sees unit-scale activations and the logits depend on the input (the
F2 guard of ROADMAP Queue 3). Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np

from av1tpu.utils.initialization import init_on_cpu

STAGE1_THRESHOLD = 0.45
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
