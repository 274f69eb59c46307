"""The host-side contracts of the wgmma kernels K4 and K5, on the CPU: the
TMA boxes over K5's conv stream, the table of the taps each 64-row tile
computes, the position-major rows of a block, and a numpy emulation of K4's
fp32 sum. The kernels themselves run only on a card
(``test_torch_port_cuda.py``).
"""
import numpy as np
import pytest
import torch

from av1tpu_torch.kernels import resnet_group as rg


def test_stream_boxes_cover_each_chunk_exactly():
    """Chunk c of the stream is 64 consecutive k-rows of the conv that uses
    it (``split_conv_stream``); the TMA boxes the kernel fetches for it (every
    block rank, every 64-column box of ``STREAM_PARTS``) cover exactly those
    values, each once, and the two parts tile the whole stream."""
    stream = torch.arange(rg.CONV_STREAM_SIZE, dtype=torch.float64)
    parts = [stream[first:first + rows * cols].reshape(rows, cols)
             for first, rows, cols in rg.STREAM_PARTS]
    assert sum(p.numel() for p in parts) == rg.CONV_STREAM_SIZE
    assert rg.STREAM_PARTS[1][0] == rg.STREAM_PARTS[0][1] * rg.STREAM_PARTS[0][2]
    rows, cols = rg.BOX
    assert cols * 2 == 128 and rows * rg.CLUSTER == rg.KC  # the 128-byte swizzle's row
    chunks = []
    for name, part in rg.split_conv_stream(stream).items():
        k_major = part.reshape(-1, part.shape[-1])
        chunks += [k_major[j:j + rg.KC] for j in range(0, k_major.shape[0], rg.KC)]
    assert len(chunks) == rg.CHUNKS
    for c, want in enumerate(chunks):
        boxes = rg.conv_stream_boxes(c)
        assert len(boxes) == rg.CLUSTER * want.shape[1] // cols
        got = torch.zeros_like(want)
        hits = torch.zeros_like(want)
        for part, row, col in boxes:
            view = parts[part][row:row + rows, col:col + cols]
            assert view.shape == (rows, cols)
            k = (row % rg.KC) + torch.arange(rows)[:, None]  # rows of the chunk
            got[k, col + torch.arange(cols)[None, :]] = view
            hits[k, col + torch.arange(cols)[None, :]] += 1
        assert torch.equal(got, want), c
        assert torch.equal(hits, torch.ones_like(hits)), c


def _inside(ie, iy, ix):
    return 0 <= iy < ie and 0 <= ix < ie


@pytest.mark.parametrize("e", rg.EXTENTS)
def test_tile_taps_match_an_enumeration_of_every_row(e):
    """A (tile, tap) is set exactly when some row of the tile (by the block's
    row order) reads inside the image at that tap: every row of every 64-row
    tile enumerated, with the tap's input position computed from the conv's
    stride and XLA's SAME padding."""
    spb = rg.samples_per_block(e)
    order1, order2 = rg.group12_row_order(e)
    table = rg.group12_tile_taps(e)
    assert table.shape == (9, 4) and table.dtype == np.uint16
    for j, (name, ie, oe, stride, taps, ci) in enumerate(rg.group12_convs(e)):
        order = order1 if j < 4 else order2
        positions = oe * oe
        tiles = len(order) // 64 if j < 4 else 1
        for tile in range(4):
            want = 0
            if tile < tiles:
                for row in order[64 * tile:64 * tile + 64]:
                    if row < 0:
                        continue  # layer 2's padding rows read only zeros
                    oy, ox = divmod(int(row) % positions, oe)
                    for tap in range(taps):
                        if taps == 1:
                            iy, ix = stride * oy, stride * ox
                        elif stride == 1:
                            iy, ix = oy + tap // 3 - 1, ox + tap % 3 - 1
                        else:  # XLA's SAME at stride 2 pads (0, 1): the window starts at 2o
                            iy, ix = 2 * oy + tap // 3, 2 * ox + tap % 3
                        if _inside(ie, iy, ix):
                            want |= 1 << tap
            assert int(table[j, tile]) == want, (name, tile)
        assert spb * positions == sum(order >= 0)


def test_tile_taps_skip_the_outside_taps_at_small_extents():
    """What skipping buys: at extent 2 layer2_0.conv1 fetches 4 of its 9 taps
    and each stride-1 conv of layer 2 its centre; in layer 1 each tile of the
    top or bottom image row computes 6 of 9 taps (extents 2 and 4). From
    extent 8 on every tap is computed."""
    fetched = lambda e: [bin(int(np.bitwise_or.reduce(row))).count("1")
                         for row in rg.group12_tile_taps(e)]
    assert fetched(2) == [9, 9, 9, 9, 4, 1, 1, 1, 1]
    assert fetched(4) == [9, 9, 9, 9, 9, 9, 1, 9, 9]
    per_tile = lambda e, j: [bin(int(v)).count("1") for v in rg.group12_tile_taps(e)[j]]
    assert per_tile(2, 0) == [6, 6, 0, 0]
    assert per_tile(4, 0) == [6, 9, 9, 6]
    for e in (8, 16):
        assert fetched(e) == [9, 9, 9, 9, 9, 9, 1, 9, 9]
        assert per_tile(e, 0) == [9, 9, 9, 9]


@pytest.mark.parametrize("e", rg.EXTENTS)
def test_rows_are_position_major_and_the_output_write_inverts_them(e):
    """Each layer's rows are a permutation of the block's (sample, position)
    rows, position-major (a 64-row tile holds whole positions), and the
    output write, sample s and position p from row p * SPB + s, returns
    every row to sample order. 4,096 samples fill at least 128 blocks."""
    spb = rg.samples_per_block(e)
    assert 4096 // spb >= 128
    for layer, (order, oe) in enumerate(zip(rg.group12_row_order(e), (e, e // 2))):
        positions = oe * oe
        real = order[order >= 0]
        assert sorted(real.tolist()) == list(range(spb * positions))
        assert len(order) == max(spb * positions, 64)
        assert np.all(order[spb * positions:] == -1)  # layer 2's padding at extent 2
        for tile in range(len(order) // 64):
            rows = real[64 * tile:64 * tile + 64]
            pos = rows % positions
            assert len(rows) == 64 or layer == 1
            assert all(np.sum(pos == p) == spb for p in set(pos.tolist()))
        written = {}
        for s in range(spb):
            for p in range(positions):
                written[s * positions + p] = order[p * spb + s]
        assert all(dst == src for dst, src in written.items())


def _round_toward_zero(v):
    """float64 -> float32, truncated (the tensor core adds to its
    accumulator so)."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _split3(v):
    top = np.uint32(0xFFFF0000)
    cut = lambda f: (f.view(np.uint32) & top).view(np.float32)
    hi = cut(v)
    mid = cut(v - hi)
    return hi, mid, (v - hi) - mid


def _k4_fp32(x, w, fold=8, step=32, hh_outside=True):
    """K4's fp32 sum in numpy: three-piece split; per k16 the five small
    products chained in the accumulator and the large one, hh, either alone
    (scale-d = 0) and added with rounded fp32 adds into a window folded every
    ``fold`` steps of ``step`` k, or chained with the small ones."""
    xp, wp = _split3(x), _split3(w)
    m, n = x.shape[0], w.shape[1]
    small, big_sum, window = (np.zeros((m, n), np.float32) for _ in range(3))
    pairs = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1))  # al bh, ah bl, am bm, am bh, ah bm
    for k0 in range(0, x.shape[1], 16):
        ks = slice(k0, k0 + 16)
        prod = lambda i, j: xp[i][:, ks].astype(np.float64) @ wp[j][ks].astype(np.float64)
        for i, j in pairs:
            small = _round_toward_zero(small.astype(np.float64) + prod(i, j))
        if hh_outside:
            window = window + _round_toward_zero(prod(0, 0))
            if (k0 + 16) % (fold * step) == 0:
                big_sum, window = big_sum + window, np.zeros_like(window)
        else:
            small = _round_toward_zero(small.astype(np.float64) + prod(0, 0))
    return (big_sum + window) + small


def test_k4_fp32_windowed_six_products_stay_within_float32_of_float64():
    """The fp32 tensor-core sum of K4 (a v6 head's 512 x 256 layer) stays
    within today's distance from a float64 product: on the card it was
    1.1e-6 of outputs up to 7.1 (NVIDIA H100, 4,099 rows), below cuBLAS's
    fp32 (5.0e-6). Here it is held below 2^-20 of the largest output and
    below a float32 product's own error; chaining hh inside the truncating
    accumulator instead is worse."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(256, 512)).astype(np.float32)
    w = (rng.normal(size=(512, 256)) / np.sqrt(512)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    ours = np.abs(_k4_fp32(x, w).astype(np.float64) - exact).max()
    fp32 = np.abs((x @ w).astype(np.float64) - exact).max()
    chained = np.abs(_k4_fp32(x, w, hh_outside=False).astype(np.float64) - exact).max()
    assert ours <= 2.0 ** -20 * scale
    assert ours <= fp32
    assert ours < chained
