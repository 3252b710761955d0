"""detect_and_select's dispatch, checks and level table on the CPU
(ops/fast_select.py), and the kernel's algorithm emulated in torch.

CPU tensors take the plain version, select_levels(detect_levels(...)), bit
for bit, and never count a launch; every call, on either device, first
passes the checks of what the CUDA kernel (csrc/fast_select.cu) takes. The
emulation repeats the kernel's steps (bf16 differences by a float32
subtraction, a cell's threshold from its high-threshold corners, NMS
against -inf outside the image, packed (score bits, ~index) keys for the
per-cell top-4 and the per-level sort, the zero-padded pool) and must give
the plain version's outputs exactly. The kernel itself is held to the plain
version on the card by tests/test_torch_fast_select_cuda.py.
"""

import pytest
import torch
import torch.nn.functional as F

from c_orb_slam_tpu_torch.config import OrbConfig
from c_orb_slam_tpu_torch.ops import extract, fast, fast_select
from fast_images import blank, checkerboard, levels_of, textured

CPU = torch.device("cpu")
# Small images, so each test stays well under a second on the CPU.
SMALL = {
    "textured_160x120_300": lambda: (textured(120, 160, 7), OrbConfig(n_features=300)),
    "tiny_64x48_500": lambda: (textured(48, 64, 5, n_rects=12), OrbConfig(n_features=500)),
    "integer_ties_96x80_300": lambda: (checkerboard(80, 96, square=5), OrbConfig(n_features=300)),
    "blank_96x80_300": lambda: (blank(80, 96), OrbConfig(n_features=300)),
}
LOW32 = 0xFFFFFFFF


def _assert_same(got, want):
    assert len(got) == len(want)
    for g_lvl, w_lvl in zip(got, want):
        for g, w in zip(g_lvl, w_lvl):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(SMALL))
def test_cpu_tensors_run_the_plain_version_and_launch_nothing(case):
    image, cfg = SMALL[case]()
    levels = levels_of(image, cfg, CPU)
    fast_select.reset_launches()
    got = fast_select.detect_and_select(levels, cfg)
    _assert_same(got, extract.select_levels(extract.detect_levels(levels, cfg), cfg))
    assert fast_select.launches == 0


def _refused(levels, cfg):
    with pytest.raises((TypeError, ValueError)) as e:
        fast_select.detect_and_select(levels, cfg)
    return e


def test_checks_refuse_what_the_kernel_does_not_take():
    cfg = OrbConfig(n_features=100, n_levels=2)
    good = [torch.rand(40, 50) * 255, torch.rand(33, 42) * 255]
    assert _refused([good[0].double(), good[1]], cfg).type is TypeError
    assert _refused([good[0].to(torch.uint8), good[1]], cfg).type is TypeError
    assert _refused([good[0][None], good[1]], cfg).type is ValueError
    assert _refused([good[0], torch.rand(42, 33).t()], cfg).type is ValueError
    assert _refused([good[0][:, ::2], good[1]], cfg).type is ValueError
    assert _refused(good[:1], cfg).type is ValueError
    assert len(fast_select.detect_and_select(good, cfg)) == 2


def test_level_table_and_limits():
    cfg = OrbConfig(n_features=2000)
    shapes = ((376, 1241), (313, 1034), (261, 862), (218, 718), (181, 598), (151, 499),
              (126, 416), (105, 346))
    plan = fast_select._plan(shapes, cfg)
    rows = [list(plan.table[9 * i:9 * i + 9]) for i in range(8)]
    budgets = cfg.features_per_level()
    assert rows[0] == [376, 1241, 13, 42, 0, 0, budgets[0], 0, 2184]
    assert rows[1][4:6] == [546, 376 * 1241] and rows[1][7] == budgets[0]
    assert plan.cells == sum(r[2] * r[3] for r in rows)
    assert plan.pixels == sum(h * w for h, w in shapes) and plan.max_pool == 2184
    with pytest.raises(ValueError, match="sort holds 16384"):
        fast_select._plan(((2160, 3840),) + shapes[1:], cfg)
    with pytest.raises(ValueError, match="sides of at least 3"):
        fast_select._plan(shapes[:7] + ((2, 346),), cfg)
    with pytest.raises(ValueError, match="cell_size"):
        fast_select._plan(shapes, OrbConfig(cell_size=65))


# --- the kernel's algorithm, emulated -------------------------------------

def _bits(x):
    return x.contiguous().view(torch.int32).to(torch.int64)


def _arc9(bits):
    w = bits | (bits << 16)
    m = w.clone()
    for i in range(1, 9):
        m &= w >> i
    return (m & 0xFFFF) != 0


def _segment(tile, v, h, w, th):
    """The segment test of every pixel: tile is the bf16-rounded level
    edge-padded by 3, v the pixels' bf16 values."""
    bright = torch.zeros((h, w), dtype=torch.int64)
    dark = torch.zeros_like(bright)
    sb = torch.zeros((h, w))
    sd = torch.zeros_like(sb)
    for k, (dy, dx) in enumerate(fast.CIRCLE):
        nb = tile[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        diff = (nb - v).to(torch.bfloat16).to(torch.float32)
        sb += torch.where(diff > th, diff - th, 0.0)
        sd += torch.where(diff < -th, -diff - th, 0.0)
        bright |= (diff > th).to(torch.int64) << k
        dark |= (diff < -th).to(torch.int64) << k
    corner = _arc9(bright) | _arc9(dark)
    return corner, torch.where(corner, torch.maximum(sb, sd), 0.0)


def _axis(c, m, p):
    denom = 2.0 * c - m - p
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    return torch.clamp(0.5 * (p - m) / denom, -0.5, 0.5)


def _emulate(levels, cfg):
    cell, border = cfg.cell_size, cfg.edge_threshold - 3
    out = []
    for img, budget in zip(levels, cfg.features_per_level()):
        h, w = img.shape
        ncy, ncx = -(-h // cell), -(-w // cell)
        v = img.to(torch.bfloat16).to(torch.float32)
        tile = v[torch.arange(-3, h + 3).clamp(0, h - 1)][:, torch.arange(-3, w + 3).clamp(0, w - 1)]
        # Launch A: a cell's threshold from its high-threshold corners.
        corner_hi, s_hi = _segment(tile, v, h, w, float(cfg.ini_th_fast))
        _, s_lo = _segment(tile, v, h, w, float(cfg.min_th_fast))
        hi = F.pad(corner_hi, (0, ncx * cell - w, 0, ncy * cell - h))
        hi = hi.reshape(ncy, cell, ncx, cell).any(3).any(1)
        hi = hi.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
        ys, xs = torch.arange(h)[:, None], torch.arange(w)[None, :]
        inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        score = torch.where(inb, torch.where(hi, s_hi, s_lo), 0.0)
        # Launch B: NMS against -inf outside the image, each cell's 4 best keys.
        halo = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
        mx = torch.stack([halo[a:a + h, b:b + w] for a in range(3) for b in range(3)]).amax(0)
        nms = torch.where((score >= mx) & (score > 0), score, 0.0)
        grid = F.pad(nms, (0, ncx * cell - w, 0, ncy * cell - h))
        grid = grid.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(-1, cell * cell)
        keys = (_bits(grid) << 32) | (LOW32 - torch.arange(cell * cell))
        top = keys.topk(4, dim=1).values  # unique keys: the order is the keys'
        idx = LOW32 - (top & LOW32)
        cid = torch.arange(ncy * ncx)[:, None]
        cand_y = ((cid // ncx) * cell + idx // cell).reshape(-1)
        cand_x = ((cid % ncx) * cell + idx % cell).reshape(-1)
        cand_bits = (top >> 32).reshape(-1)
        # Launch C: the level's pool, padded to its budget, sorted by key.
        n_cand, pool = cand_bits.numel(), max(cand_bits.numel(), budget)
        pool_bits = F.pad(cand_bits, (0, pool - n_cand))
        pool_keys = (pool_bits << 32) | (LOW32 - torch.arange(pool))
        kept = pool_keys.sort(descending=True).values[:budget]
        j = LOW32 - (kept & LOW32)
        real = j < n_cand
        jc = j.clamp(max=n_cand - 1)
        y = torch.where(real, cand_y[jc], 0)
        x = torch.where(real, cand_x[jc], 0)
        resp = (kept >> 32).to(torch.int32).view(torch.float32)
        y0, x0 = (y - 1).clamp(0, h - 3), (x - 1).clamp(0, w - 3)
        c = nms[y0 + 1, x0 + 1]
        sub = torch.stack([_axis(c, nms[y0, x0 + 1], nms[y0 + 2, x0 + 1]),
                           _axis(c, nms[y0 + 1, x0], nms[y0 + 1, x0 + 2])], -1)
        out.append((torch.stack([y, x], -1).to(torch.int32), resp, resp > 0.0, sub))
    return out


@pytest.mark.parametrize("case", sorted(SMALL))
def test_kernel_algorithm_emulated_equals_the_plain_version(case):
    image, cfg = SMALL[case]()
    levels = levels_of(image, cfg, CPU)
    _assert_same(_emulate(levels, cfg), fast_select.detect_and_select_reference(levels, cfg))
