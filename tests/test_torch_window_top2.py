"""The algorithm of the window_top2 CUDA kernel (csrc/window_top2.cu),
emulated in numpy, against the plain PyTorch version, exact, on the CPU.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py). What can
be held here is its arithmetic: targets dealt to P interleaved lanes, a
per-lane top-2 over in-window valid pairs only, as packed keys
distance << 23 | index, a butterfly merge that keeps the two smallest
keys, and the closed-form fill of the ranks that belong to masked pairs,
which the kernel never visits. Exact because all of it is integer.
"""

import numpy as np
import pytest
import torch

from c_orb_slam_tpu_torch.ops import window_top2 as w2

# Input generators shared with the GPU tests (a module free of jax).
from test_torch_cuda import KERNEL_CASES, _t, _window_case

INDEX_BITS = 23
NO_KEY = np.uint32(0xFFFFFFFF)


def _emulate(c, lanes):
    """(best, idx, second, idx2) of one (Q, .) x (T, .) problem by the
    kernel's algorithm with `lanes` lanes per query."""
    assert w2.MAX_TARGETS == 1 << INDEX_BITS
    qd, td = c["q_desc"].view(np.uint32), c["t_desc"].view(np.uint32)
    Q, T = len(qd), len(td)
    k1 = np.full((Q, lanes), NO_KEY)
    k2 = np.full((Q, lanes), NO_KEY)
    u, v, r = c["q_uv"][:, 0], c["q_uv"][:, 1], np.where(c["q_valid"], c["q_radius"], -1.0)
    for k in range(T):  # lane k % lanes visits target k
        x, y = c["t_xy"][k]
        inside = (c["t_valid"][k] & (np.abs(u - x) <= r) & (np.abs(v - y) <= r)
                  & (c["t_octave"][k] >= c["q_lo"]) & (c["t_octave"][k] <= c["q_hi"]))
        dist = np.unpackbits((qd ^ td[k]).view(np.uint8), axis=1).sum(1).astype(np.uint32)
        key = np.where(inside, (dist << INDEX_BITS) | np.uint32(k), NO_KEY)  # a miss inserts nothing
        lane = k % lanes
        k2[:, lane] = np.minimum(k2[:, lane], np.maximum(k1[:, lane], key))
        k1[:, lane] = np.minimum(k1[:, lane], key)
    off = lanes // 2
    while off:  # the __shfl_xor_sync butterfly
        other = np.arange(lanes) ^ off
        o1, o2 = k1[:, other], k2[:, other]
        k1, k2 = np.minimum(k1, o1), np.minimum(np.maximum(k1, o1), np.minimum(k2, o2))
        off //= 2
    assert (k1 == k1[:, :1]).all() and (k2 == k2[:, :1]).all()  # every lane holds the result
    k1, k2 = k1[:, 0], k2[:, 0]
    mask = np.uint32((1 << INDEX_BITS) - 1)
    has1, has2 = k1 != NO_KEY, k2 != NO_KEY
    idx = np.where(has1, k1 & mask, 0).astype(np.int32)
    best = np.where(has1, k1 >> INDEX_BITS, 512).astype(np.int32)
    second = np.where(has2, k2 >> INDEX_BITS, 512).astype(np.int32)
    fill = 0 if T == 1 else np.where(idx == 0, 1, 0)
    idx2 = np.where(has2, k2 & mask, fill).astype(np.int32)
    return best, idx, second, idx2


@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_algorithm_matches_plain_version(case, lanes):
    spec = KERNEL_CASES[case]
    if spec["T"] > 1000:  # the tiling cases: same algorithm, a shorter walk here
        spec = {**spec, "T": spec["T"] // 10 + 3}
    c = _window_case(11, **spec)
    want = [x.numpy() for x in w2.window_top2_reference(**{k: _t(v) for k, v in c.items()})]
    batch = spec.get("batch")
    for b in range(min(batch or 1, 4)):
        cb = {k: v[b] for k, v in c.items()} if batch else c
        got = _emulate(cb, lanes)
        for name, g, w in zip(("best", "idx", "second", "idx2"), got, want):
            np.testing.assert_array_equal(g, w[b] if batch else w, err_msg=f"{name}, batch {b}")


def test_edge_cases_reach_their_ranks():
    """The generators give what their names say: one candidate at index 0
    (second rank filled at index 1), and no candidate at all."""
    c = _window_case(11, **KERNEL_CASES["target0_only_60x50"])
    best, idx, second, idx2 = _emulate(c, 8)
    live = c["q_valid"]
    assert live.any() and (best[live] <= 256).all() and (idx[live] == 0).all()
    assert (second == 512).all() and (idx2 == 1).all()
    for name in ("targets_invalid_40x70", "queries_invalid_40x70"):
        got = _emulate(_window_case(11, **KERNEL_CASES[name]), 8)
        for g, w in zip(got, (512, 0, 512, 1)):
            assert (g == w).all()


def test_kernel_limits_bind_only_the_kernel():
    """More targets than a packed key can index, and descriptor rows off
    the 16-byte alignment of the kernel's vector loads, are refused for the
    kernel; the plain version, which CPU tensors take, has neither limit."""
    c = {k: _t(v) for k, v in _window_case(17, Q=4, T=6).items()}
    w2._check_kernel_limits(c, 6)
    flat = torch.zeros(4 * 8 + 1, dtype=torch.int32)
    flat[1:] = c["q_desc"].reshape(-1)
    shifted = {**c, "q_desc": flat[1:].view(4, 8)}
    with pytest.raises(ValueError, match="aligned"):
        w2._check_kernel_limits(shifted, 6)
    for got, want in zip(w2.window_top2(**shifted), w2.window_top2(**c)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="targets"):
        w2._check_kernel_limits(c, w2.MAX_TARGETS + 1)


def test_launch_shapes_reset_with_launches():
    w2.launch_shapes[(1, 2, 3)] = 4
    w2.reset_launches()
    assert w2.launches == 0 and w2.launch_shapes == {}
