"""The port's CUDA kernel on the card: window_top2 (csrc/window_top2.cu)
against its plain PyTorch version, exact, and search_by_projection on CUDA
tensors launching it. Marked ``cuda``; skipped where no GPU is visible.
Run them on the GPU with ``python -m pytest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from c_orb_slam_tpu_torch.ops import match, window_top2 as w2

pytestmark = pytest.mark.cuda


def _desc(rng, shape, pool=None):
    """uint32 descriptor words; with `pool`, drawn from that many distinct
    descriptors (distance ties everywhere)."""
    if pool:
        words = rng.integers(0, 2**32, (pool, 8), dtype=np.uint64).astype(np.uint32)
        return words[rng.integers(0, pool, shape)]
    return rng.integers(0, 2**32, shape + (8,), dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy -> torch, uint32 descriptor words as their int32 bit pattern."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _window_case(seed, Q, T, *, masked_rows=False, ties=False, batch=None, edge=None):
    """Inputs of window_top2 / search_by_projection like the main path's:
    queries projected near some targets, radius 15 px x level scale.
    `edge`: "target0_only" leaves target 0 as the only one in any window,
    "targets_invalid" / "queries_invalid" clear that side's valid flags."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    td = _desc(rng, lead + (T,), pool=3 if ties else None)
    txy = rng.uniform(0, [640, 480], lead + (T, 2)).astype(np.float32)
    near = rng.integers(0, T, lead + (Q,))
    if ties:
        qd = _desc(rng, lead + (Q,), pool=3)
    else:  # noisy copies of the target each query projects near
        flips = (rng.random(lead + (Q, 8, 32)) < 0.05) << np.arange(32, dtype=np.uint64)
        qd = np.take_along_axis(td, near[..., None], -2) ^ flips.sum(-1).astype(np.uint32)
    quv = (np.take_along_axis(txy, near[..., None].repeat(2, -1), -2)
           + rng.normal(0, 6, lead + (Q, 2))).astype(np.float32)
    lo = rng.integers(0, 6, lead + (Q,)).astype(np.int32)
    qr = np.full(lead + (Q,), 2000.0, np.float32) if ties else (15.0 * 1.2**lo).astype(np.float32)
    qv = rng.random(lead + (Q,)) > 0.1
    if masked_rows:
        qv[..., : Q // 2] = False
    toct = rng.integers(0, 8, lead + (T,)).astype(np.int32)
    tv = rng.random(lead + (T,)) > 0.05
    if edge == "target0_only":
        quv = (txy[..., :1, :] + rng.normal(0, 3, lead + (Q, 2))).astype(np.float32)
        txy[..., 1:, :] += 5000.0
        tv[..., 0] = True
        toct[..., 0] = 2  # inside [lo, lo + 2] for lo in 0..2
        lo = np.minimum(lo, 2)
    elif edge == "targets_invalid":
        tv[:] = False
    elif edge == "queries_invalid":
        qv[:] = False
    return dict(
        q_desc=qd, q_uv=quv, q_radius=qr, q_lo=lo,
        q_hi=np.minimum(lo + 2, 7).astype(np.int32), q_valid=qv,
        t_desc=td, t_xy=txy, t_octave=toct, t_valid=tv,
    )


SEARCH_CASES = {
    "motion_model_100x100": dict(Q=100, T=100),
    "local_map_820x100": dict(Q=820, T=100),
    "unaligned_200x300": dict(Q=200, T=300),
    "masked_rows_64x100": dict(Q=64, T=100, masked_rows=True),
    "single_target_30x1": dict(Q=30, T=1),
    "ties_100x100": dict(Q=100, T=100, ties=True),
}


# Edge cases of the masked ranks (the kernel never visits a masked pair
# and fills its ranks in closed form) and of the kernel's tiling: T below,
# at and off a warp's 32 lanes, Q off a block's queries, T over one tile.
EDGE_CASES = {
    "two_targets_40x2": dict(Q=40, T=2),
    "targets_33_50x33": dict(Q=50, T=33),
    "target0_only_60x50": dict(Q=60, T=50, edge="target0_only"),
    "targets_invalid_40x70": dict(Q=40, T=70, edge="targets_invalid"),
    "queries_invalid_40x70": dict(Q=40, T=70, edge="queries_invalid"),
}
KERNEL_CASES = {
    **SEARCH_CASES,
    **EDGE_CASES,
    "batch_4x100x100": dict(Q=100, T=100, batch=4),
    "batch_32x37x45": dict(Q=37, T=45, batch=32),
    "off_tile_77x2300": dict(Q=77, T=2300),
    "ties_off_tile_45x2100": dict(Q=45, T=2100, ties=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    return torch.device("cuda", 0)


def _on(c, dev):
    return {k: _t(v).to(dev) for k, v in c.items()}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_matches_plain_version(cuda, case):
    args = _on(_window_case(11, **KERNEL_CASES[case]), cuda)
    before = w2.launches
    got = w2.window_top2(**args)
    torch.cuda.synchronize()
    assert w2.launches == before + 1
    lead = args["q_valid"].shape
    assert w2.launch_shapes[(lead[0] if len(lead) == 2 else 1, lead[-1], args["t_valid"].shape[-1])] >= 1
    for g, r in zip(got, w2.window_top2_reference(**args)):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())


def test_search_by_projection_launches_the_kernel(cuda):
    c = _window_case(7, Q=300, T=200)
    order = ("q_uv", "q_radius", "q_desc", "q_valid", "t_xy", "t_octave", "t_desc",
             "t_valid", "q_lo", "q_hi")
    before = w2.launches
    on_gpu = match.search_by_projection(*(_t(c[k]).to(cuda) for k in order), nn_ratio=0.8)
    assert w2.launches == before + 1
    on_cpu = match.search_by_projection(*(_t(c[k]) for k in order), nn_ratio=0.8)
    for g, r in zip(on_gpu, on_cpu):
        np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())


def test_fetch_done_polls_without_waiting(cuda):
    """The staged jobs poll Fetch.done() every frame: it must answer from
    an event query while the device is still busy, and result() must wait."""
    from c_orb_slam_tpu_torch.utils.host import fetch_async

    a = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    x = a
    for _ in range(60):  # a few hundred ms of queued device work
        x = x @ a
        x = x / x.abs().max()
    fut = fetch_async(x[:4, :4])
    early = fut.done()
    got = fut.result()
    assert fut.done()
    assert not early, "done() waited for the device, or the work was too short to tell"
    np.testing.assert_array_equal(got, x[:4, :4].cpu().numpy())


def test_staged_loop_correction_drains_on_the_card(cuda):
    """tests/test_torch_loop_correction.py's tiny stereo system on the
    card: a correction armed by hand runs fuse, essential graph and
    global BA through fetch_async and releases the mapper."""
    from test_torch_loop_correction import _arm_correction, _tiny_system

    sysm = _tiny_system(device=cuda)
    lc = _arm_correction(sysm)
    assert lc.correction_job is not None and sysm.local_mapping.paused
    n = 0
    while not lc.idle():
        lc.advance_background()
        n += 1
        assert n < 500, "the staged correction never finished"
    assert n >= sysm.cfg.optimizer.essential_graph_its + 2 * sysm.cfg.optimizer.global_ba_its
    assert lc.n_gba_applied == 1 and not sysm.local_mapping.paused
    sysm.shutdown()
    assert np.isfinite(sysm.map.kf_pose[sysm.map.live_keyframes()]).all()
    assert np.isfinite(sysm.map.pt_xyz[sysm.map.live_points()]).all()
