"""Port parity of two library options on the CPU: ``run_pipeline_batched``'s
producer (``prefetch``) and ``utils.initialization.init_on_cpu``.

The batching cases are the counterparts of the JAX package's
(``tests/test_eval.py``): the same predictor, written once for each package,
streams the same numpy blocks through both packages' loops, whose outputs
must be equal for ``prefetch`` 0, 2 and 4, on an array and on a memmap; an
exception in the producer reaches the caller; a caller that stops ends the
producer. ``init_on_cpu`` draws flax's initializers from an explicit
generator: the same seed gives the same weights bit for bit, in the tree
layout of the JAX package's ``init_on_cpu`` (flax's ``init``), and they pass
through ``models.jax_import`` unchanged.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.eval import run_pipeline_batched as jax_batched
from av1tpu_torch import models as tm
from av1tpu_torch.eval import hierarchy
from av1tpu_torch.eval import run_pipeline_batched
from av1tpu_torch.models import load_jax_variables, to_jax_variables
from av1tpu_torch.utils import init_on_cpu
from tests.torch_port_fixtures import images_u16

N, BATCH = 300, 64  # five batches, a tail of 44 rows


def _port_predict(chunk):
    x = chunk.to(torch.float32)
    return {"final": (x.sum(dim=(1, 2, 3)) % 8).to(torch.int32),
            "mean": x.mean(dim=(1, 2, 3)) / 1023.0}


def _jax_predict(chunk):
    x = chunk.astype(jnp.float32)
    return {"final": (x.sum(axis=(1, 2, 3)) % 8).astype(jnp.int32),
            "mean": x.mean(axis=(1, 2, 3)) / 1023.0}


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """300 seeded 16 px blocks as an array and as a read-only memmap."""
    images = images_u16(90, N, 16)
    path = tmp_path_factory.mktemp("blocks") / "blocks.npy"
    np.save(path, images)
    return {"array": images, "memmap": np.load(path, mmap_mode="r")}


@pytest.fixture(scope="module")
def jax_out(blocks):
    return jax_batched(jax.jit(_jax_predict), blocks["array"], batch_size=BATCH)


@pytest.mark.parametrize("prefetch", [0, 2, 4])
@pytest.mark.parametrize("source", ["array", "memmap"])
def test_prefetch_outputs_equal_jax(blocks, jax_out, source, prefetch):
    """Every ``prefetch`` gives the serial loop's outputs bit for bit, and
    the JAX package's loop's (rtol 1e-6 for the float mean)."""
    got = run_pipeline_batched(_port_predict, blocks[source], BATCH, device="cpu",
                               prefetch=prefetch)
    serial = run_pipeline_batched(_port_predict, blocks["array"], BATCH, device="cpu",
                                  prefetch=0)
    assert sorted(got) == sorted(jax_out)
    for key, value in serial.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    np.testing.assert_array_equal(got["final"], jax_out["final"])
    np.testing.assert_allclose(got["mean"], jax_out["mean"], rtol=1e-6)
    assert len(got["final"]) == N and len(np.unique(got["final"])) > 1


def test_prefetch_carries_qps_and_valid_rows(blocks):
    """The QPs beside each batch, and a capacity-style predictor's padded
    batches and valid counts, come through the producer as through the
    serial loop."""
    qps = np.arange(N, dtype=np.float32) / 255.0

    def with_qps(chunk, qp):
        return {"out": chunk.to(torch.float32).mean(dim=(1, 2, 3)) + qp}

    def gated(chunk, valid):
        assert chunk.shape[0] == BATCH
        return {"rows": chunk[:, 0, 0, 0].to(torch.int32),
                "valid": torch.tensor(valid, dtype=torch.int32)}

    gated.accepts_valid = True
    for predict, kwargs in ((with_qps, {"qps": qps}), (gated, {})):
        want = run_pipeline_batched(predict, blocks["array"], BATCH, device="cpu",
                                    prefetch=0, **kwargs)
        got = run_pipeline_batched(predict, blocks["memmap"], BATCH, device="cpu",
                                   prefetch=2, **kwargs)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    np.testing.assert_array_equal(got["valid"], [64, 64, 64, 64, 44])


def test_tensor_input_bypasses_the_producer(blocks, monkeypatch):
    """A tensor (already on the device) is sliced on the caller's thread: no
    producer thread starts."""

    def no_thread(*args, **kwargs):
        raise AssertionError("a producer thread started")

    monkeypatch.setattr(hierarchy.threading, "Thread", no_thread)
    got = run_pipeline_batched(_port_predict, torch.from_numpy(blocks["array"]), BATCH,
                               device="cpu", prefetch=2)
    want = run_pipeline_batched(_port_predict, blocks["array"], BATCH, device="cpu",
                                prefetch=0)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_prefetch_propagates_producer_errors():
    """An exception in the producer (a bad read while staging a batch)
    surfaces in the caller instead of hanging the queue."""

    class Flaky(np.ndarray):
        def __getitem__(self, item):
            if isinstance(item, slice) and item.start == 16:
                raise RuntimeError("bad sector")
            return super().__getitem__(item)

    samples = np.zeros((64, 4), np.float32).view(Flaky)
    with pytest.raises(RuntimeError, match="bad sector"):
        run_pipeline_batched(lambda chunk: {"final": chunk[:, 0]}, samples, batch_size=16,
                             device="cpu", prefetch=2)


def test_prefetch_releases_the_producer():
    """When the predictor raises mid-stream, the producer notices and ends
    instead of blocking on a full queue."""
    before = {t.ident for t in threading.enumerate()}

    def predict(chunk):
        raise RuntimeError("consumer died")

    with pytest.raises(RuntimeError, match="consumer died"):
        run_pipeline_batched(predict, np.zeros((128, 4), np.float32), batch_size=8,
                             device="cpu", prefetch=1)
    deadline = time.time() + 10
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.ident not in before and t.daemon and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.1)
    assert not leaked, f"producer thread leaked: {leaked}"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield path, tree if isinstance(tree, jax.ShapeDtypeStruct) else np.asarray(tree)


@pytest.mark.parametrize("name", ["stage1", "unified"])
def test_init_on_cpu_is_seeded_and_bridges(name):
    """The same seed gives bitwise the same weights (a generator or its int
    seed), another seed others; the tree has the paths, shapes and dtypes of
    the JAX package's ``init_on_cpu`` (flax's ``model.init``); loading it into
    a model on any device and reading it back gives it unchanged. BatchNorm
    starts as flax's: scale 1, bias 0, running statistics 0 and 1."""
    port_cls, jax_cls = {"stage1": (tm.Stage1Model, jm.Stage1Model),
                         "unified": (tm.UnifiedV6Model, jm.UnifiedV6Model)}[name]
    sample = torch.zeros((2, 16, 16, 1))
    first = dict(_leaves(init_on_cpu(port_cls(), 7, sample)))
    again = dict(_leaves(init_on_cpu(port_cls(), torch.Generator().manual_seed(7))))
    other = dict(_leaves(init_on_cpu(port_cls(), 8)))
    assert sorted(first) == sorted(again) == sorted(other)
    for path, value in first.items():
        np.testing.assert_array_equal(again[path], value, err_msg=str(path))
    kernels = [p for p in first if p[-1] == "kernel"]
    assert all(not np.array_equal(other[p], first[p]) for p in kernels)

    # the layout of the JAX package's init_on_cpu, which returns model.init's
    # tree as numpy: traced for its shapes only, nothing drawn
    want = dict(_leaves(jax.eval_shape(lambda: jax_cls().init(
        jax.random.PRNGKey(7), jnp.zeros((2, 16, 16, 1))))))
    assert sorted(first) == sorted(want)
    for path, value in want.items():
        assert first[path].shape == value.shape and first[path].dtype == value.dtype, path
        if path[-1] in ("scale", "var"):
            np.testing.assert_array_equal(first[path], 1.0)
        elif path[-1] in ("bias", "mean"):
            np.testing.assert_array_equal(first[path], 0.0)

    back = dict(_leaves(to_jax_variables(load_jax_variables(
        port_cls(), init_on_cpu(port_cls(), 7)).state_dict())))
    assert sorted(back) == sorted(first)
    for path, value in first.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
        assert back[path].dtype == value.dtype


def test_init_on_cpu_leaves_the_model_and_refuses_a_card_generator():
    """The caller's module keeps its weights and device; a generator that is
    not the CPU's is refused (a card's generator draws other numbers)."""
    model = tm.Stage3RectModel()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    init_on_cpu(model, 1)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key

    class CardGenerator:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="CPU generator"):
        init_on_cpu(model, CardGenerator())
