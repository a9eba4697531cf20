"""The roofline's byte and operation counts at a small shape, against a
count of the touched pixels made one window at a time."""

import torch

from gvins_bench import reference as ref
from gvins_bench import roofline as rf


def _frames(seed=0, H=96, W=128):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((H // 8, W // 8), generator=g) * 255
    img = torch.nn.functional.interpolate(base[None, None], size=(H, W), mode="bicubic", align_corners=False)[0, 0]
    return img.clamp(0, 255), torch.roll(img, shifts=(1, 2), dims=(0, 1)).clamp(0, 255)


def _touched(img, pts, half, pad):
    """The pixels of ``img`` under each slice, one point at a time."""
    H, W = img.shape
    size = 2 * half + 2
    seen = torch.zeros((H, W), dtype=torch.bool)
    for x, y in pts.tolist():
        x0 = min(max(int(torch.floor(torch.tensor(x + pad))) - half, 0), W + 2 * pad - size)
        y0 = min(max(int(torch.floor(torch.tensor(y + pad))) - half, 0), H + 2 * pad - size)
        for yy in range(y0, y0 + size):
            for xx in range(x0, x0 + size):
                seen[min(max(yy - pad, 0), H - 1), min(max(xx - pad, 0), W - 1)] = True
    return int(seen.sum())


def test_clahe_counts():
    assert rf.clahe_apply((10, 20), 4, (441, 256), 2) == (800 + 441 * 256 * 2 + 800, 2200)


def test_lk_counts_match_a_window_by_window_count():
    a, b = _frames()
    pyr_a, pyr_b = ref.pyramid(a), ref.pyramid(b)
    pts = torch.tensor([[40.0, 30.0], [90.5, 60.25], [3.0, 4.0], [120.0, 90.0]])
    valid = torch.tensor([True, True, True, False])
    n_bytes, n_ops = rf.lk_pyr(pyr_a, pyr_b, pts, pts, valid)
    log = []
    ref.lk_pyr(pyr_a, pyr_b, pts, pts, valid, log=log)
    expect_px = 0
    per_image = {}
    for img_prev, img_next, pp, guess, gate, ok, _ in log:
        per_image.setdefault(img_prev.data_ptr(), [img_prev, []])[1].append((pp[gate], ref.LK_WIN_HALF + 1))
        per_image.setdefault(img_next.data_ptr(), [img_next, []])[1].append((guess[ok], ref.LK_WIN_HALF))
    for img, uses in per_image.values():
        idx = torch.cat([rf.slice_pixels(img, p, h, ref.LK_PAD) for p, h in uses])
        expect_px += int(torch.unique(idx).numel())
        if len(uses) == 1:
            assert int(torch.unique(idx).numel()) == _touched(img, *uses[0], ref.LK_PAD)
    assert n_bytes == 4 * expect_px + 4 * 8 + 4 * 8 + 4 + 4 * 9
    steps = sum(int(s.sum()) for *_, s in log)
    slot_levels = sum(int(g.sum()) for *_, g, _, _ in log)
    assert n_ops == slot_levels * (529 * 7 + 441 * 10) + steps * 441 * 12
    assert slot_levels >= 4 * 3


def test_subpix_counts():
    a, _ = _frames(1)
    corners = torch.tensor([[40.0, 30.0], [41.0, 31.0], [100.0, 70.0]])
    valid = torch.tensor([True, True, False])
    n_bytes, n_ops = rf.subpix(a, corners, valid)
    _, steps = ref.subpix(a, corners, valid)
    px = _touched(a, corners[valid], ref.SUBPIX_HALF + 1, 0)
    assert n_bytes == 4 * px + corners.numel() * 4 + 3 + corners.numel() * 4
    assert n_ops == int(steps.sum()) * (169 * 7 + 121 * 20) and int(steps[2]) == 0


def test_least_time_takes_the_larger_bound():
    assert rf.least_s(3.35e12, 1.0) == 1.0
    assert rf.least_s(1.0, 67e12) == 1.0
