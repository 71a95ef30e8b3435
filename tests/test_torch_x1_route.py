"""X1's route on wgmma + TMA (``nkbx_torch/ops/csrc/matmul_bn.cu``,
``matmul_bn_wgmma_kernel``) on the CPU: the parts of it that are host
arithmetic or an order of sums.

- A numpy model of the route's statistics in f32, in the kernel's order:
  each block's row tiles g, g + groups, ... of its column tile; in a tile,
  for each of the 8 warps (16 rows each) and column, a thread's two rows r
  and r + 8 first, then the xor-shuffle tree over the 8 lanes of a column,
  ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7)); each warp's running sum
  over the tiles; the block's partial row, the 8 warps added in order; then
  ``column_sums``: 32 lanes each adding the partial rows l, l + 32, ... in
  order, and the lanes added in order. It agrees with
  ``reference_matmul_bn_relu_stats`` within 1e-5 relative and keeps rows >=
  N out by selection (relu(bias) is not 0 on a padded row).
- The route's predicate at the probe's shapes and ResNet's 1x1 widths.
"""

import numpy as np
import pytest
import torch

from nkbx_torch.ops import matmul_bn as tmb


ROWS = 128  # rows of one of the route's tiles


def route_grid(n, cout, sms):
    """The route's grid as ``nkbx_matmul_bn_wgmma`` sets it on a card of
    ``sms`` SMs: ``bn`` columns a block (128, or 64 where Cout is not a
    multiple of 128), ``col_tiles`` of them, ``row_tiles`` of 128 rows, and
    ``groups`` blocks a column tile, block g taking row tiles g, g + groups,
    ... in order (the order of its running sums)."""
    bn = 128 if cout % 128 == 0 else 64
    col_tiles, row_tiles = cout // bn, -(-n // ROWS)
    return dict(bn=bn, col_tiles=col_tiles, row_tiles=row_tiles,
                groups=max(1, min(row_tiles, sms // col_tiles)))


def route_sums(v, n, cout, sms):
    """(sum, sumsq) of the f32 y ``v`` (rows padded to whole 128-row tiles;
    rows >= n hold relu(bias), the padded rows' value) in the route's order."""
    g = route_grid(n, cout, sms)
    bn, groups, row_tiles = g["bn"], g["groups"], g["row_tiles"]
    assert v.shape == (row_tiles * ROWS, cout) and v.dtype == np.float32
    keep = (np.arange(v.shape[0]) < n)[:, None]
    parts = np.zeros((2, groups, cout), np.float32)
    for k, val in enumerate((v, v * v)):
        val = np.where(keep, val, np.float32(0))  # selection, not arithmetic
        for c in range(g["col_tiles"]):
            cols = slice(c * bn, (c + 1) * bn)
            for grp in range(groups):
                run = np.zeros((8, bn), np.float32)  # a running sum a warp
                for t in range(grp, row_tiles, groups):
                    tile = val[t * 128:(t + 1) * 128, cols].reshape(8, 16, bn)
                    pair = tile[:, :8] + tile[:, 8:]  # rows r and r + 8, (8 warps, 8 lanes, bn)
                    s1 = pair[:, :4] + pair[:, 4:]  # lanes l and l ^ 4 (lane bit 4)
                    s2 = s1[:, :2] + s1[:, 2:]  # l and l ^ 2 (bit 3)
                    run += s2[:, 0] + s2[:, 1]  # l and l ^ 1 (bit 2)
                part = run[0].copy()
                for w in range(1, 8):
                    part += run[w]
                parts[k, grp, cols] = part
    out = []
    for k in range(2):  # column_sums: lane l adds rows l, l + 32, ..., then the lanes in order
        lanes = np.zeros((32, cout), np.float32)
        for lane in range(32):
            for t in range(lane, groups, 32):
                lanes[lane] += parts[k, t]
        total = lanes[0].copy()
        for lane in range(1, 32):
            total += lanes[lane]
        out.append(total)
    return out


@pytest.mark.parametrize("n,cin,cout,sms", [(1000, 64, 128, 4), (777, 128, 192, 3),
                                            (4000, 64, 64, 132), (300, 64, 256, 5)])
def test_the_route_statistics_order_matches_the_plain_sums(n, cin, cout, sms):
    x, w, scale, bias = tmb.inputs(n, cin, cout, torch.float32, "cpu", seed=n)
    bias = bias + 0.5  # relu(bias) > 0: a padded row that leaked would show
    _, ps, pq = tmb.reference_matmul_bn_relu_stats(x, w, scale, bias)
    rows = route_grid(n, cout, sms)["row_tiles"] * ROWS
    xp = torch.cat([x, x.new_zeros(rows - n, cin)])  # TMA reads rows >= n as zeros
    v = torch.relu((xp @ w) * scale + bias).numpy()
    assert (v[n:] > 0).any()
    s, q = route_sums(v, n, cout, sms)
    for got, want in ((s, ps), (q, pq)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    leaked = route_sums(v, rows, cout, sms)[0]  # the same sums with the padded rows kept
    assert np.abs(leaked - s).max() > 1e-3 * np.abs(s).max()


@pytest.mark.parametrize("n,c", tmb.SHAPES)
def test_every_probe_shape_takes_the_route(n, c):
    assert tmb.takes_wgmma(n, c, c, torch.bfloat16)
    assert not tmb.takes_wgmma(n, c, c, torch.float32)


@pytest.mark.parametrize("cin,cout,takes", [
    (64, 256, True), (256, 64, True), (128, 512, True), (512, 128, True), (256, 1024, True),
    (512, 2048, True), (1024, 256, False), (2048, 512, False), (96, 64, False), (64, 80, False)])
def test_the_route_predicate_at_resnet_widths(cin, cout, takes):
    """ResNet's 1x1 convolutions (bottleneck reduce and expand, stages 1-4):
    the route takes Cin up to 512 (w's slice stays in shared memory) and
    widths that are multiples of 64."""
    assert tmb.takes_wgmma(50_176, cin, cout, torch.bfloat16) == takes
