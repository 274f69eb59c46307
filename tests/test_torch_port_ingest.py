"""The port's data layer and ETL (ROADMAP M13) beside the JAX package, on the
CPU; host numpy only, no JAX compile.

Inputs: a clip rendered from partition trees with one encoder dump per frame
(``chip_smoke.tree_clip``, the generator of ``chip_smoke.py``'s path i) at a
small size whose superblocks overhang both edges, and a copy with the
malformed inputs of the drive recipe's probes (short and non-integer dump
lines, an order hint that disagrees with its file name, an inter frame, a
dump beyond the clip's end, trailing bytes). On the same inputs:

* ``data.synth_tree``: equal trees, superblocks and BlockSets for a seed;
* ``ingest.partition_dump`` and ``ingest.xlsx``: equal records and warnings;
  equal workbooks, member by member (zip headers hold the write time);
* ``ingest.native``: the native reader and tiler equal the numpy path, and
  without the library the module falls back to numpy;
* ``ingest.etl``: equal extracts and reports for each option,
  ``write_reference_layout`` byte-equal, ``write_npz`` member-equal;
* the four ``data.records`` loaders: equal BlockSets and arrays;
* the ``prepare_data`` and ``prepare_dataset`` CLIs: equal output trees.
"""
import dataclasses
import json
import shutil
import subprocess
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from av1tpu.cli import prepare_data as jax_prepare_data
from av1tpu.cli import prepare_dataset as jax_prepare_dataset
from av1tpu.data import records as jrec
from av1tpu.data import synth_tree as jtree
from av1tpu.ingest import etl as jetl
from av1tpu.ingest import native as jnative
from av1tpu.ingest import partition_dump as jdump
from av1tpu.ingest import tiler as jtiler
from av1tpu.ingest import xlsx as jxlsx
from av1tpu.ingest import yuv as jyuv
from av1tpu_torch.cli import prepare_data, prepare_dataset
from av1tpu_torch.data import records, synth_tree
from av1tpu_torch.ingest import etl, native, partition_dump, xlsx, yuv
from chip_smoke import differing_files, tree_clip

REPO = Path(__file__).resolve().parents[1]
CLIP = (3, 200, 264)  # frames, height, width: 4 x 5 superblocks, both edges partial
SIZES = ("64", "32", "16", "8")


def _fields(obj):
    """A dataclass's fields (nested ones too) as comparable values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fields(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.shape, obj.tobytes())
    return obj


def _same_blockset(got, want):
    assert _fields(got) == _fields(want)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The clip, its dumps, workbooks of those dumps, and the probe copy."""
    root = tmp_path_factory.mktemp("torch_port_ingest")
    clip = tree_clip(root / "raw", CLIP, 7)
    jxlsx.export_dump_dir_to_xlsx(clip["dumps"], root / "xlsx", "clip")
    probes = root / "probes"
    shutil.copytree(clip["dumps"], probes / "dumps")
    yuv_bytes = clip["yuv"].read_bytes() + b"\x00" * 10  # trailing bytes
    (probes / clip["yuv"].name).write_bytes(yuv_bytes)
    with open(probes / "dumps" / "partition_frame_1.txt", "a") as f:
        f.write("1 0 12 0 0\n"          # short
                "1 0 12 0 x 3 80\n"     # non-integer field
                "\n"
                "2 0 12 0 16 1 90\n"    # order hint of another frame
                "1 1 12 0 32 2 90\n")   # inter frame: dropped
    (probes / "dumps" / "partition_frame_9.txt").write_text("9 0 12 0 0 3 80\n")
    yield {"root": root, "clip": clip, "xlsx": root / "xlsx",
           "probe_yuv": probes / clip["yuv"].name, "probe_dumps": probes / "dumps"}
    shutil.rmtree(root)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The native library built from ``native/`` into a private directory
    (``make TARGET=...``), so that no other test's build is overwritten."""
    target = tmp_path_factory.mktemp("native_lib") / "libav1tpu_io.so"
    result = subprocess.run(["make", "-C", str(REPO / "native"), f"TARGET={target}"],
                            capture_output=True, text=True)
    if result.returncode != 0:
        pytest.skip(f"native build failed: {result.stderr[-500:]}")
    yield target
    shutil.rmtree(target.parent)


@pytest.fixture
def with_native(native_lib, monkeypatch):
    """Both packages' readers on the private build."""
    monkeypatch.setenv("AV1TPU_NATIVE_LIB", str(native_lib))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(jnative, "_lib", None)
    assert native.native_available() and jnative.native_available()


@pytest.fixture
def without_native(monkeypatch):
    monkeypatch.delenv("AV1TPU_NATIVE_LIB", raising=False)
    for module in (native, jnative):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_LIB_CANDIDATES", ())
    assert not native.native_available() and not jnative.native_available()


# ---------------------------------------------------------------------------
# data.synth_tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("probs", [None, ({64: 0.9, 32: 0.6, 16: 0.5}, {0: 0.5, 1: 0.3, 7: 0.2})],
                         ids=["default", "custom"])
def test_sample_trees_matches_jax(probs):
    args = probs or (None, None)
    got = synth_tree.sample_trees(40, np.random.default_rng(3), *args)
    want = jtree.sample_trees(40, np.random.default_rng(3), *args)
    assert got.dtype == want.dtype and got.shape == (40, 85)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique((got >= 0).sum(axis=1))) > 3  # the trees vary


def test_render_and_per_size_blocksets_match_jax():
    trees = jtree.sample_trees(24, np.random.default_rng(4))
    got = synth_tree.render_superblocks(trees, np.random.default_rng(5))
    want = jtree.render_superblocks(trees, np.random.default_rng(5))
    assert got.dtype == want.dtype == np.uint16 and got.shape == (24, 64, 64, 1)
    np.testing.assert_array_equal(got, want)
    sets = synth_tree.per_size_blocksets(got, trees, np.random.default_rng(6))
    jsets = jtree.per_size_blocksets(want, trees, np.random.default_rng(6))
    assert sorted(sets) == sorted(jsets) == [8, 16, 32, 64]
    for size in sets:
        _same_blockset(sets[size], jsets[size])
        assert sets[size].block_size == size


def test_tree_corpus_matches_jax():
    got, want = synth_tree.tree_corpus(16, seed=9), jtree.tree_corpus(16, seed=9)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for size in want[2]:
        _same_blockset(got[2][size], want[2][size])


# ---------------------------------------------------------------------------
# ingest.partition_dump, ingest.xlsx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["clip", "probes"])
def test_dump_parser_matches_jax(raw, which):
    dumps = raw["clip"]["dumps"] if which == "clip" else raw["probe_dumps"]
    assert ([p.name for p in partition_dump.discover_dump_files(dumps)]
            == [p.name for p in jdump.discover_dump_files(dumps)])
    got, want = partition_dump.parse_dump_directory(dumps), jdump.parse_dump_directory(dumps)
    assert _fields(got) == _fields(want)
    warnings = [w for r in got for w in r.warnings]
    if which == "probes":
        assert any("malformed line" in w for w in warnings)
        assert any("non-integer field" in w for w in warnings)
        assert any("order_hint != 1" in w for w in warnings)
    else:
        assert warnings == [] and sum(r.intra_blocks for r in got) == sum(
            raw["clip"]["nodes"].values())
    with pytest.raises(ValueError):
        partition_dump.frame_index_from_name(Path("frame_1.txt"))


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return [(name, zf.read(name)) for name in zf.namelist()]


def test_xlsx_matches_jax(raw, tmp_path):
    results = partition_dump.parse_dump_directory(raw["probe_dumps"])
    for result in results:
        name = f"clip-intra-{result.frame_index}.xlsx"
        got = xlsx.write_frame_xlsx(tmp_path / "port" / name, result)
        want = jxlsx.write_frame_xlsx(tmp_path / "jax" / name, result)
        assert _members(got) == _members(want)
        assert _fields(xlsx.read_frame_xlsx(got)) == _fields(jxlsx.read_frame_xlsx(want))
        assert _fields(xlsx.parse_xlsx_file(got)) == _fields(jxlsx.parse_xlsx_file(want))
    written = xlsx.export_dump_dir_to_xlsx(raw["probe_dumps"], tmp_path / "export", "clip",
                                           middle_word="intra")
    assert [p.name for p in written] == [
        p.name for p in jxlsx.export_dump_dir_to_xlsx(raw["probe_dumps"],
                                                      tmp_path / "jax_export", "clip")]
    assert differing_files(tmp_path / "export", tmp_path / "jax_export") == []
    assert _fields(xlsx.parse_xlsx_directory(tmp_path / "export")) == _fields(
        jxlsx.parse_xlsx_directory(tmp_path / "export"))
    # a workbook whose sheets lost their last two columns (frame type, order
    # hint): both packages pad with zeros
    src, cut = written[0], tmp_path / "cut" / written[0].name
    cut.parent.mkdir()
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(cut, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name).decode()
            if name.startswith("xl/worksheets/"):
                for col in "EF":
                    data = "".join(part.split("</c>", 1)[-1] if i else part for i, part in
                                   enumerate(data.split(f'<c r="{col}')))
            zout.writestr(name, data)
    assert _fields(xlsx.parse_xlsx_file(cut)) == _fields(jxlsx.parse_xlsx_file(cut))
    assert xlsx.read_frame_xlsx(cut)["64"].shape[1] == 4
    with pytest.raises(ValueError):
        xlsx.frame_index_from_xlsx_name(Path("clip.xlsx"))


# ---------------------------------------------------------------------------
# ingest.native
# ---------------------------------------------------------------------------


def _geometry():
    return yuv.Yuv420p10Geometry(width=CLIP[2], height=CLIP[1])


def test_native_reader_equals_numpy(raw, with_native):
    path, geom = raw["clip"]["yuv"], _geometry()
    frames = [2, 0, 1]
    got = native.read_y_frames(path, geom, frames, validate_range=True)
    want = yuv.read_y_frames_batch(path, geom, frames)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, jyuv.read_y_frames_batch(path, jyuv.Yuv420p10Geometry(CLIP[2], CLIP[1]), frames))
    for bs in (64, 16, 8):
        tiles = native.tile_frames(got, bs)
        np.testing.assert_array_equal(tiles, jtiler.tile_frames(got, bs)[0])
        np.testing.assert_array_equal(tiles, jnative.tile_frames(got, bs))
    assert native.probe_yuv(raw["probe_yuv"], geom) == jnative.probe_yuv(
        raw["probe_yuv"], geom) == (CLIP[0], 10)
    with pytest.raises(IOError):
        native.read_y_frames(path, geom, [CLIP[0]])


def test_without_the_library_native_falls_back_to_numpy(raw, without_native):
    path, geom = raw["clip"]["yuv"], _geometry()
    got = native.read_y_frames(path, geom, [1, 2])
    np.testing.assert_array_equal(got, yuv.read_y_frames_batch(path, geom, [1, 2]))
    np.testing.assert_array_equal(native.tile_frames(got, 32), jtiler.tile_frames(got, 32)[0])
    assert native.probe_yuv(raw["probe_yuv"], geom) == (CLIP[0], 10)


# ---------------------------------------------------------------------------
# ingest.etl
# ---------------------------------------------------------------------------

ETL_CASES = {  # name: (extract_sequence kwargs, needs the native library)
    "native": ({}, True),
    "numpy": ({"use_native": False}, False),
    "constant80": ({"qp_mode": "constant80", "use_native": False}, False),
    "xlsx": ({"dump_format": "xlsx", "use_native": False}, False),
    "two_frames_two_sizes": ({"max_frames": 2, "block_sizes": (32, 8)}, True),
    "probes": ({"use_native": False}, False),
}


@pytest.mark.parametrize("case", list(ETL_CASES))
def test_extract_and_writers_match_jax(raw, request, tmp_path, case):
    kwargs, needs_native = ETL_CASES[case]
    request.getfixturevalue("with_native" if needs_native else "without_native")
    path, dumps = raw["clip"]["yuv"], raw["clip"]["dumps"]
    if case == "probes":
        path, dumps = raw["probe_yuv"], raw["probe_dumps"]
    elif case == "xlsx":
        dumps = raw["xlsx"]
    got, report = etl.extract_sequence(path, dumps, **kwargs)
    want, jreport = jetl.extract_sequence(path, dumps, **kwargs)
    assert _fields(got) == _fields(want)
    assert _fields(report) == _fields(jreport)
    assert sorted(got) == sorted(kwargs.get("block_sizes", (8, 16, 32, 64)))
    if case == "probes":
        assert "10 trailing bytes ignored" in report.warnings
        assert any("frame 9 beyond file" in w for w in report.warnings)
    if case == "constant80":
        assert all((ext.qps == etl.CONSTANT_QP).all() for ext in got.values())
    etl.write_reference_layout(got, tmp_path / "port", "clip", verify=True, report=report)
    jetl.write_reference_layout(want, tmp_path / "jax", "clip", verify=True, report=jreport)
    assert ([Path(f).relative_to(tmp_path / "port") for f in report.files_written]
            == [Path(f).relative_to(tmp_path / "jax") for f in jreport.files_written])
    written = etl.write_npz(got, tmp_path / "port" / "npz", "clip")
    jetl.write_npz(want, tmp_path / "jax" / "npz", "clip")
    assert [p.name for p in written] == [f"clip_block{bs}.npz" for bs in got]
    assert differing_files(tmp_path / "port", tmp_path / "jax") == []


def test_extract_refuses_a_name_without_geometry(raw, tmp_path):
    odd = tmp_path / "clip.yuv"
    shutil.copy(raw["clip"]["yuv"], odd)
    for module in (etl, jetl):
        with pytest.raises(ValueError, match="cannot infer WxH"):
            module.extract_sequence(odd, raw["clip"]["dumps"])
    got, _ = etl.extract_sequence(odd, raw["clip"]["dumps"], resolution=(CLIP[2], CLIP[1]),
                                  use_native=False)
    want, _ = jetl.extract_sequence(odd, raw["clip"]["dumps"], resolution=(CLIP[2], CLIP[1]),
                                    use_native=False)
    assert _fields(got) == _fields(want)


# ---------------------------------------------------------------------------
# data.records loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts(raw):
    """The clip's reference layout and npz, written by the JAX package."""
    out = raw["root"] / "layout"
    extracts, _ = jetl.extract_sequence(raw["clip"]["yuv"], raw["clip"]["dumps"],
                                        use_native=False)
    jetl.write_reference_layout(extracts, out, "clip")
    jetl.write_reference_layout(extracts, out, "other")  # a second sequence
    jetl.write_npz(extracts, out / "npz", "clip")
    jetl.write_npz(extracts, out / "npz", "other")
    return out


def test_index_and_load_reference_layout_match_jax(layouts):
    assert records.index_sequences(layouts) == jrec.index_sequences(layouts)
    for size in SIZES:
        got = records.load_reference_layout(layouts, size)
        _same_blockset(got, jrec.load_reference_layout(layouts, size))
        assert len(got) > 0 and got.samples.dtype == np.uint16
    for module in (records, jrec):
        with pytest.raises(ValueError):
            module.load_reference_layout(layouts, "12")
        with pytest.raises(FileNotFoundError):
            module.index_sequences(layouts / "npz")


def test_load_npz_sequences_matches_jax(layouts):
    for size in (64, 32, 16, 8):
        got = records.load_npz_sequences(layouts / "npz", size)
        _same_blockset(got, jrec.load_npz_sequences(layouts / "npz", size))
        _same_blockset(got, records.load_reference_layout(layouts, str(size)))
    for module in (records, jrec):
        with pytest.raises(RuntimeError):
            module.load_npz_sequences(layouts, 16)


def test_load_torch_bundle_matches_jax(tmp_path):
    """A reference ``train.pt``: NCHW float samples (already normalized),
    labels, QPs and plain metadata."""
    gen = torch.Generator().manual_seed(0)
    payload = {"image": torch.rand(6, 1, 16, 16, generator=gen),
               "samples": torch.rand(6, 1, 8, 8, generator=gen),
               "label": torch.randint(0, 8, (6,), generator=gen),
               "qp": torch.full((6,), 80, dtype=torch.uint8),
               "block_size": 16, "class_names": ["NONE", "SPLIT"]}
    torch.save(payload, tmp_path / "train.pt")
    arrays, meta = records.load_torch_bundle(tmp_path / "train.pt")
    jarrays, jmeta = jrec.load_torch_bundle(tmp_path / "train.pt")
    assert _fields(arrays) == _fields(jarrays) and meta == jmeta
    assert arrays["image"].shape == (6, 16, 16, 1) and arrays["samples"].shape == (6, 8, 8, 1)
    np.testing.assert_array_equal(arrays["image"][..., 0], payload["image"][:, 0].numpy())


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

CLI_CASES = {  # name: (prepare_data flags, prepare_dataset flags)
    "v6": (["--formats", "reference", "npz"], ["--variant", "v6"]),
    "v5_from_npz": (["--formats", "reference", "npz"], ["--variant", "v5", "--format", "npz"]),
    "xlsx_constant80_partitioned": (
        ["--dump-format", "xlsx", "--qp-mode", "constant80", "--formats", "reference", "npz",
         "--sequence-name", "seq", "--resolution", f"{CLIP[2]}x{CLIP[1]}", "--max-frames", "2",
         "--block-sizes", "16", "8", "--no-verify"],
        ["--variant", "flatten", "--partitioned-only", "--test-ratio", "0.3", "--seed", "3"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_prepare_cli_outputs_match_jax(raw, tmp_path, case, without_native):
    data_flags, dataset_flags = CLI_CASES[case]
    dumps = raw["xlsx"] if "xlsx" in data_flags else raw["clip"]["dumps"]
    sizes = (["16", "8"] if "--block-sizes" in data_flags else list(SIZES))
    for name, data_cli, dataset_cli in (("port", prepare_data, prepare_dataset),
                                        ("jax", jax_prepare_data, jax_prepare_dataset)):
        out = tmp_path / name
        data_cli.main(["--yuv", str(raw["clip"]["yuv"]), "--dumps", str(dumps),
                       "--out", str(out / "raw"), *data_flags])
        src = out / "raw" / "npz" if "npz" in dataset_flags else out / "raw"
        dataset_cli.main(["--raw", str(src), "--out", str(out / "dataset"),
                          "--block-size", *sizes, *dataset_flags])
    assert differing_files(tmp_path / "port", tmp_path / "jax") == []
    report = json.loads(next((tmp_path / "port" / "raw").glob("*_etl_report.json")).read_text())
    assert report["qp_mode"] == ("constant80" if "constant80" in data_flags else "real")
    for size in sizes:
        meta = json.loads((tmp_path / "port" / "dataset" / f"block_{size}"
                           / "metadata.json").read_text())
        assert meta["train_samples"] > 0 and meta["val_samples"] > 0
