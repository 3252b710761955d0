"""The FAST detection and selection kernel on the card: csrc/fast_select.cu,
launched by ops/fast_select.py::detect_and_select on CUDA tensors, against
detect_and_select_reference (select_levels(detect_levels(...))) on the same
CUDA level tensors. Marked ``cuda``; skipped where no GPU is visible. Run
them on the GPU with
``python -m pytest --noconftest tests/test_torch_fast_select_cuda.py``.

Tolerances: yx, response and valid of every slot, invalid ones included,
are equal exactly (the scores are sums of exact terms; the selection is an
order). The subpixel offsets are within 1e-6: both sides divide the same
float32 numbers, correctly rounded.
"""

import numpy as np
import pytest
import torch

from c_orb_slam_tpu_torch.ops import fast_select
from fast_images import CASES, levels_of

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    image, cfg = CASES[case]()
    levels = levels_of(image, cfg, cuda)
    before = fast_select.launches
    got = fast_select.detect_and_select(levels, cfg)
    torch.cuda.synchronize()
    assert fast_select.launches == before + 3
    want = fast_select.detect_and_select_reference(levels, cfg)
    assert len(got) == len(want) == cfg.n_levels
    for lvl, ((gyx, gr, gv, gs), (wyx, wr, wv, ws)) in enumerate(zip(got, want)):
        for label, g, w in (("yx", gyx, wyx), ("response", gr, wr), ("valid", gv, wv),
                            ("subpixel", gs, ws)):
            assert g.dtype == w.dtype and g.shape == w.shape, (case, lvl, label)
        assert torch.equal(gyx, wyx), (case, lvl, "yx")
        assert torch.equal(gr, wr), (case, lvl, "response")
        assert torch.equal(gv, wv), (case, lvl, "valid")
        np.testing.assert_allclose(gs.cpu().numpy(), ws.cpu().numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"{case} level {lvl} subpixel")


def test_launch_repeats_its_bits(cuda):
    image, cfg = CASES["kitti_1241x376_2000"]()
    levels = levels_of(image, cfg, cuda)
    first = [torch.cat([t.reshape(-1).float() for t in lvl]) for lvl in
             fast_select.detect_and_select(levels, cfg)]
    for _ in range(3):
        again = fast_select.detect_and_select(levels, cfg)
        for a, lvl in zip(first, again):
            assert torch.equal(a, torch.cat([t.reshape(-1).float() for t in lvl]))
