"""The host-side contracts of K1's and K2's wgmma kernels (``csrc/fused_front.cu``),
on the CPU, by numpy emulations of what the kernels do with them: the TMA
box that lays down each sample's tile (zeros at negative coordinates and past
the batch), the A fragments each lane builds from the tile by word loads, the
max-pool done in registers with shuffles (and, at 16 px, one row passed
between warps), K2's position-major rows and the output write that inverts
them, K2's tile-tap table against its own rows, and K1's staged, swizzled
output rows. The kernels themselves run only on a card
(``test_torch_port_cuda.py``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av1tpu_torch.kernels import fused_front as ff
from av1tpu_torch.kernels import resnet_group as rg

SIZES = pytest.mark.parametrize("hw", [8, 16])


def _pixels(n, hw, seed=0):
    rng = np.random.default_rng(seed + hw)
    return rng.integers(0, 1024, (n, hw, hw)).astype(np.float32) / 1023.0


def _box(x, b0, hw, samples):
    """A TMA box read of x (B, hw, hw) at ``x_box``'s origin from sample b0:
    zero fill wherever the coordinates leave the array, the batch included."""
    (depth, rows, cols), origin, _ = ff.x_box(hw, samples)
    assert min(origin) >= 0  # TMA takes no negative coordinates
    out = np.zeros((depth, rows, cols), x.dtype)
    for s in range(depth):
        for r in range(rows):
            for c in range(cols):
                b, y, xx = b0 + s + origin[0], r + origin[1], c + origin[2]
                if b < len(x) and 0 <= y < hw and 0 <= xx < hw:
                    out[s, r, c] = x[b, y, xx]
    return out


def _tiles(box, hw):
    """The tiles the stem reads: the buffer from ``x_box``'s lead of zeros in
    front of the box on, one H x W block a sample."""
    (_, rows, cols), _, lead = ff.x_box(hw, len(box))
    flat = np.concatenate([np.zeros(lead, box.dtype), box.ravel()])
    return flat[:box.size].reshape(box.shape)


def _geometry(hw):
    co = hw // 2
    xp = co // 2
    return co, xp, 8 // xp, 64 // (co * co)  # conv extent, lane groups a row, rows a warp, samples a tile


@SIZES
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_tma_box_lays_down_the_tiles_the_stem_reads(hw, kernel):
    """Each kernel's box (K2: a block's samples, K1: a group's) over a batch
    whose last box is short, read from its lead on: every sample's block is
    the sample padded 3 rows above, 4 columns left (``stem_gemm_index``'s
    tile), past the batch zeros, and the stem GEMM on it is the 7x7/2 conv,
    zero for the missing samples. The lead's last element read is its last:
    the stem reads nothing before the lead."""
    samples = ff.g1_samples_per_block(hw) if kernel == "k2" else ff.k1_samples_per_group(hw)
    batch = 2 * samples - 3 if samples > 3 else samples + 1
    x = _pixels(batch, hw)
    w = np.random.default_rng(1).standard_normal((49, 64)).astype(np.float32)
    gemm_w = ff.stem_gemm_weight(torch.from_numpy(w)).numpy()
    index = ff.stem_gemm_index(hw).numpy()
    for b0 in range(0, batch, samples):
        tiles = _tiles(_box(x, b0, hw, samples), hw)
        n = min(samples, batch - b0)
        want = np.zeros_like(tiles)
        want[:n] = np.pad(x[b0:b0 + n], ((0, 0), (3, 3), (4, 4)))
        assert np.array_equal(tiles, want), b0
        conv = tiles.reshape(samples, -1)[:, index] @ gemm_w  # (samples, positions, 64)
        ref = F.conv2d(torch.from_numpy(x[b0:b0 + n])[:, None],
                       torch.from_numpy(w.T.reshape(64, 1, 7, 7)), stride=2, padding=3)
        np.testing.assert_allclose(conv[:n], ref.flatten(2).transpose(1, 2).numpy(), atol=1e-5)
        assert not conv[n:].any()
    _, _, lead = ff.x_box(hw, samples)
    assert lead == 3 * (hw + 8) + 4 and int(index.min()) == 0  # tile element 0: the lead's first


@SIZES
def test_stem_tile_rows_cover_the_tiles_conv_positions(hw):
    """A 64-row stem tile holds every conv position of its samples once (one
    sample at 16 px, four at 8 px), each lane two neighbouring columns."""
    co, _, _, spt = _geometry(hw)
    rows = ff.stem_tile_rows(hw)
    assert rows.shape == (64, 3)
    assert sorted(map(tuple, rows.tolist())) == [
        (s, y, x) for s in range(spt) for y in range(co) for x in range(co)]
    r = np.arange(64)
    low, high = rows[r % 16 < 8], rows[r % 16 >= 8]  # fragment halves h = 0, 1 of each lane
    assert np.array_equal(low[:, :2], high[:, :2]) and np.all(high[:, 2] == low[:, 2] + 1)
    assert np.all(low[:, 2] % 2 == 0)


@SIZES
def test_a_fragments_from_word_loads_are_the_gemm_rows(hw):
    """Lane (w, g, t) of a tile loads, for k16 step kk, the words at p0, p1 =
    p0 + 2, plus 2 kk or 2 kk + 1 tile rows, where p0 = sample * SIZE + 2 y W
    + 4 (g % XP) + 2 t (``stem_mma``): the four registers are exactly the
    A fragment of rows g and g + 8 (k 2t.. and 2t + 8..) of the implicit GEMM
    that ``stem_gemm_index`` defines, in the tile's own row order."""
    co, xp, rw, spt = _geometry(hw)
    width, height = hw + 8, hw + 6
    size = width * height
    index = ff.stem_gemm_index(hw).numpy()
    rows = ff.stem_tile_rows(hw)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                y_all = w * rw + g // xp
                p0 = y_all // co * size + 2 * (y_all % co) * width + 4 * (g % xp) + 2 * t
                p1 = p0 + 2
                for kk in range(4):
                    words = [p0 + 2 * kk * width, p1 + 2 * kk * width,
                             p0 + (2 * kk + 1) * width, p1 + (2 * kk + 1) * width]
                    for reg, (half, k0) in enumerate(((0, 0), (1, 0), (0, 8), (1, 8))):
                        s, y, x = rows[16 * w + 8 * half + g]
                        k = 16 * kk + k0 + 2 * t
                        element = s * size + index[y * co + x, k]
                        assert words[reg] == element and element % 2 == 0
                        assert index[y * co + x, k + 1] == index[y * co + x, k] + 1


def _shfl_up(v, d):
    """__shfl_up_sync over a warp's lanes (axis 0): lane L reads L - d, or
    keeps its own value below d."""
    out = v.copy()
    out[d:] = v[:-d]
    return out


def _shfl_xor(v, d):
    return v[np.arange(32) ^ d]


def _pool_in_registers(conv, hw):
    """``stem_pool`` on one tile's relu'd conv values ``conv`` (64 rows in the
    tile's order, channels), lane by lane: returns {(sample, position): value}
    over all 64 channels, from the channel blocks each lane finishes."""
    co, xp, rw, _ = _geometry(hw)
    so = hw // 4
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    k = g % xp
    pooled, edge, finish = {}, {}, []
    for w in range(4):
        # a lane's two rows are 16 w + g and 16 w + g + 8; its channels 8 j + 2 t, + 1
        v0, v1 = conv[16 * w + g], conv[16 * w + g + 8]  # (32 lanes, 64 channels)
        left = _shfl_up(v1, 4)
        m = np.maximum(v0, v1)
        m = np.where((k > 0)[:, None], np.maximum(m, left), m)
        y = (w * rw + g // xp) % co
        blocks = m.reshape(32, 8, 8)  # lane, channel block j, channel in the block
        odd = y % 2
        # the row pair (lanes l, l ^ 4 XP) trades halves: the even row's lane
        # finishes blocks 0-3, the odd row's 4-7
        mine = np.where(odd[:, None, None] == 1, blocks[:, 4:], blocks[:, :4])
        send = np.where(odd[:, None, None] == 1, blocks[:, :4], blocks[:, 4:])
        out = np.maximum(mine, _shfl_xor(send, 4 * xp))
        if rw == 2:  # 16 px: the previous warp's odd row comes after the barrier
            for lane in lanes[odd == 1]:
                if w < 3:
                    edge[(w, k[lane])] = blocks[lane].copy()
        else:  # 8 px: row 1 (lanes 8-15), by two indexed shuffles, for rows 2 and 3
            src = 8 + lanes % 8
            lo, hi = blocks[src, :4], blocks[src, 4:]
            above = np.where(odd[:, None, None] == 1, hi, lo)
            out = np.where((y >= 2)[:, None, None], np.maximum(out, above), out)
        finish.append((out, y, 4 * odd))
    for w, (out, y, first) in enumerate(finish):  # after the warpgroup's barrier
        # every lane carries all its channels here; lane t of the kernel holds
        # channels 8 j + 2 t, + 1, and every shift above keeps t (4 lanes a g)
        for lane in lanes[(first >= 0) & (t == 0)]:
            value = out[lane]
            nb = len(value)
            if rw == 2 and w > 0:  # the row above the pair: the previous warp's odd row
                value = np.maximum(value, edge[(w - 1, k[lane])][first[lane]:first[lane] + nb])
            s = (w * rw + g[lane] // xp) // co
            p = y[lane] // 2 * so + k[lane]
            part = pooled.setdefault((s, p), np.full((8, 8), np.nan, value.dtype))
            assert np.isnan(part[first[lane]:first[lane] + nb]).all()
            part[first[lane]:first[lane] + nb] = value
    return {key: part.reshape(-1) for key, part in pooled.items()}


@SIZES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["k2_fp32", "k1_bf16"])
def test_in_register_pool_is_the_3x3_stride_2_max_pool(hw, dtype):
    """The pool of ``stem_pool`` (columns by one shuffle; rows by one trade of
    half the channel blocks within a row pair, and the row above the pair
    from the previous warp at 16 px, by two indexed shuffles at 8 px) gives
    every channel of every pooled value of the tile's samples once and equals
    F.max_pool2d(3, 2, 1) of the relu'd conv, in fp32 (K2's residual) and on
    bf16-rounded values (K1's output: rounding is monotone)."""
    co, _, _, spt = _geometry(hw)
    so = hw // 4
    rng = np.random.default_rng(hw)
    grid = np.maximum(rng.standard_normal((spt, 64, co, co)), 0).astype(np.float32)  # s, c, y, x
    grid = torch.from_numpy(grid).to(dtype).float().numpy()
    rows = ff.stem_tile_rows(hw)
    conv = grid[rows[:, 0], :, rows[:, 1], rows[:, 2]]  # (64 rows, 64 channels)
    pooled = _pool_in_registers(conv, hw)
    assert sorted(pooled) == [(s, p) for s in range(spt) for p in range(so * so)]
    want = F.max_pool2d(torch.from_numpy(grid), 3, stride=2, padding=1).numpy()
    for (s, p), value in pooled.items():
        assert not np.isnan(value).any()
        assert np.array_equal(value, want[s, :, p // so, p % so]), (s, p)


@SIZES
def test_k2_rows_are_position_major_and_the_output_write_inverts_them(hw):
    """K2's stem writes pooled position p of stem tile st's sample s to row
    p * SPB + st * SPT + s: over the block's tiles a permutation of its rows,
    equal to K5's layer-1 row order at extent hw / 4; the output loop (row
    p * SPB + s for destination s * P + p) returns every row to sample order.
    4,096 samples fill at least 128 blocks."""
    e = hw // 4
    positions = e * e
    spb = ff.g1_samples_per_block(hw)
    _, _, _, spt = _geometry(hw)
    assert 4096 // spb >= 128 and spb % spt == 0
    holder = {}  # row -> (sample of the block, position)
    for st in range(spb // spt):
        for s in range(spt):
            for p in range(positions):
                row = p * spb + st * spt + s
                assert row not in holder
                holder[row] = (st * spt + s, p)
    assert sorted(holder) == list(range(spb * positions))
    order = rg.group12_row_order(e)[0]  # sample-major row each layer-1 row holds
    for row, (s, p) in holder.items():
        assert order[row] == s * positions + p
    for dst in range(spb * positions):
        s, p = divmod(dst, positions)
        assert holder[p * spb + s] == (s, p)


@SIZES
def test_k2_tile_taps_match_an_enumeration_of_its_rows(hw):
    """The rows of K5's table that K2 reads (its four layer-1 convs, stride 1,
    SAME) against an enumeration of every row of every 64-row tile of K2's
    block, by the position the stem wrote there; a tap no tile reads is not
    fetched."""
    e = hw // 4
    spb = ff.g1_samples_per_block(hw)
    rows = spb * e * e
    table = rg.group12_tile_taps(e)
    for j in range(4):
        for tile in range(4):
            want = 0
            for row in range(64 * tile, min(64 * tile + 64, rows)):
                oy, ox = divmod(row // spb, e)
                for tap in range(9):
                    iy, ix = oy + tap // 3 - 1, ox + tap % 3 - 1
                    if 0 <= iy < e and 0 <= ix < e:
                        want |= 1 << tap
            assert int(table[j, tile]) == want, (j, tile)
    fetched = [bin(int(np.bitwise_or.reduce(table[j]))).count("1") for j in range(4)]
    assert fetched == [9, 9, 9, 9]


@SIZES
def test_k1_staged_rows_reach_every_output_row_once(hw):
    """K1's worker stages pooled value (tile t, sample s, position p) at row
    (t * SPT + s) * P + p of its group, each 16-byte chunk j at chunk
    j ^ (row % 8) (the store map's 128-byte swizzle), and stores the group at
    output row group * G * P; rows past the batch are clipped. Over a ragged
    batch every output element is written exactly once."""
    co, _, _, spt = _geometry(hw)
    so = hw // 4
    positions = so * so
    per_group = ff.k1_samples_per_group(hw)
    tiles = per_group // spt
    batch = 3 * per_group - 1
    written = np.zeros((batch * positions, 64), np.int64)
    for group in range(-(-batch // per_group)):
        stage = np.full(per_group * positions * 128, -1, np.int64)  # bytes of the staging buffer
        for t in range(tiles):
            for s in range(spt):
                for p in range(positions):
                    row = (t * spt + s) * positions + p
                    for j in range(8):
                        for c in range(8):  # channels 8 j + c, two bytes each
                            at = row * 128 + ((j ^ (row % 8)) << 4) + 2 * c
                            assert stage[at] == -1
                            stage[at:at + 2] = ((group * per_group + t * spt + s) * positions
                                                + p) * 64 + 8 * j + c
        assert (stage >= 0).all()
        for row in range(per_group * positions):  # the store: un-swizzle, clip
            out_row = group * per_group * positions + row
            if out_row >= batch * positions:
                continue
            for j in range(8):
                chunk = stage[row * 128 + ((j ^ (row % 8)) << 4):][:16:2]
                assert np.array_equal(chunk, out_row * 64 + 8 * j + np.arange(8))
                written[out_row, 8 * j:8 * j + 8] += 1
    assert (written == 1).all()


@SIZES
def test_k2_stem_stores_meet_distinct_banks_and_write_each_block_once(hw):
    """Every lane of a warp finishes 4 of the 8 channel blocks of a pooled
    value, from 4 * (row % 2), and writes rows SPB apart (the same banks);
    each rotates its blocks by its position p % 4 (the kernel's
    ``rotate_blocks``: by 1, then by 2), so the store of block
    first + (q + rot) % 4 writes that block's value, every block of a
    position once, and one store's lanes need no more passes than their
    bytes: in the fp32 plane (float2 a lane, rows of 72 floats) and in the
    bf16 plane (one word a lane, rows of 72 bf16)."""
    co, xp, rw, spt = _geometry(hw)
    so = hw // 4
    spb = ff.g1_samples_per_block(hw)
    pitch = 64 + 8
    nb = 4
    for w in range(4):
        lanes = []
        for lane in range(32):
            g, t = lane // 4, lane % 4
            y_all = w * rw + g // xp
            y, s = y_all % co, y_all // co
            lanes.append((t, s, y // 2 * so + g % xp, 4 * (y % 2)))
        written = {}
        for q in range(nb):
            fp32_banks, bf16_banks = [], []
            for t, s, p, first in lanes:
                rot = p % 4
                blocks = list(range(nb))
                for step in (1, 2):  # rotate_blocks
                    if rot & step:
                        blocks = [blocks[(i + step) % nb] for i in range(nb)]
                assert blocks[q] == (q + rot) % nb  # the value written is the block's own
                row = p * spb + s
                j = first + (q + rot) % nb
                written[(row, j, t)] = written.get((row, j, t), 0) + 1
                col = 8 * j + 2 * t
                fp32_banks += [(row * pitch + col) % 32, (row * pitch + col + 1) % 32]
                bf16_banks.append((row * pitch + col) // 2 % 32)
            for banks in (fp32_banks, bf16_banks):
                passes = -(-len(banks) // 32)
                assert max(np.bincount(banks)) == passes, (w, q)
        assert sorted(set(j for _, j, _ in written)) == list(range(8))
        assert set(written.values()) == {1}
