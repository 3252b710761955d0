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
    import types

    from c_orb_slam_tpu_torch.system import System
    from test_torch_loop_correction import TORCH, _arm_correction, _tiny_system

    on_card = types.SimpleNamespace(**{**vars(TORCH),
                                       "system": lambda cfg, **kw: System(cfg, cuda, **kw),
                                       "tensor": lambda a: TORCH.tensor(a).to(cuda)})
    sysm = _tiny_system(on_card)
    lc = _arm_correction(on_card, sysm)
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


def _ba_terms(dev, C=64, P=8192, O=16384, seed=3):
    """A local-BA bucket's observation ids (every point seen 2 times on
    average, cameras in random order) and random residuals, Jacobians and
    weights of that size, as a BAProblem the sums read ids and sizes from."""
    from c_orb_slam_tpu_torch.optim import ba

    g = torch.Generator().manual_seed(seed)
    z = lambda *s: torch.zeros(s)  # noqa: E731
    p = ba.BAProblem(
        cam_T=z(C, 3, 4), cam_fixed=torch.zeros(C, dtype=torch.bool),
        cam_valid=torch.ones(C, dtype=torch.bool), points=z(P, 3),
        point_valid=torch.ones(P, dtype=torch.bool),
        obs_cam=torch.randint(0, C, (O,), generator=g, dtype=torch.int32),
        obs_pt=torch.randint(0, P, (O,), generator=g, dtype=torch.int32),
        obs_uv=z(O, 3), obs_stereo=torch.zeros(O, dtype=torch.bool), obs_inv_sigma2=z(O),
        obs_valid=torch.ones(O, dtype=torch.bool), K=z(4), bf=torch.tensor(0.0))
    terms = (torch.randn(O, 3, generator=g), torch.randn(O, 3, 6, generator=g),
             torch.randn(O, 3, 3, generator=g), torch.rand(O, generator=g))
    p = ba.sort_by_point(p)
    return (ba.BAProblem(*(x.to(dev) for x in p)), tuple(t.to(dev) for t in terms))


def _same_each_time(fn, n=20):
    """fn() n times: every output bit-equal to the first run's."""
    first = [x.cpu() for x in fn()]
    for _ in range(n - 1):
        for a, b in zip(first, fn()):
            assert torch.equal(a, b.cpu())
    return first


def test_ordered_segment_sums_repeat_bitwise(cuda):
    """ops/segment.segment_sum and the BA sums built on it, 20 times each on
    the card: the same bits every run (index_add_ adds with float atomics
    there), and the CPU's sums within float32 rounding."""
    from c_orb_slam_tpu_torch.ops import segment
    from c_orb_slam_tpu_torch.optim import ba

    g = torch.Generator().manual_seed(0)
    for n_rows, n_seg, shape in ((16384, 64, (42,)), (16384, 8192, (12,)), (100000, 1, ()),
                                 (4000, 100001, ())):
        ids = torch.randint(0, n_seg, (n_rows,), generator=g)
        x = torch.randn((n_rows, *shape), generator=g)
        seg = segment.segments(ids.to(cuda), n_seg)
        got = _same_each_time(lambda: [segment.segment_sum(x.to(cuda), seg)])[0]
        want = segment.segment_sum(x, ids, n_seg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-3)
    p, terms = _ba_terms(cuda)
    segs = ba.segs_of(p)
    sums = _same_each_time(lambda: ba._normal_sums(p, *terms, segs))
    W = _same_each_time(lambda: [ba._w_blocks(p, *terms[1:], segs)])[0]
    y = torch.randn(p.points.shape[0], 3, generator=g).to(cuda)
    x = torch.randn(p.cam_T.shape[0], 6, generator=g).to(cuda)
    _same_each_time(lambda: [ba._w_times(p, *terms[1:], y, segs),
                             ba._wt_times(p, *terms[1:], x, segs)])
    p_cpu, t_cpu = _ba_terms(torch.device("cpu"))
    for a, b in zip((*sums, W), (*ba._normal_sums(p_cpu, *t_cpu), ba._w_blocks(p_cpu, *t_cpu[1:]))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-3)


def test_pose_graph_and_bow_sums_repeat_bitwise(cuda):
    """A pose-graph gn_step (its gradient, preconditioner and every PCG
    matvec are ordered sums) on 512 vertices with chain, skip and random
    edges, and BoW aggregation and scoring, 20 times each on the card: the
    same bits every run."""
    from c_orb_slam_tpu_torch.bow import database
    from c_orb_slam_tpu_torch.geometry import sim3
    from c_orb_slam_tpu_torch.optim import pose_graph

    g = torch.Generator().manual_seed(1)
    K = 512
    gt = sim3.exp(torch.randn(K, 7, generator=g) * 0.3)
    ei = torch.cat([torch.arange(K - 1), torch.arange(K - 2), torch.randint(0, K, (2000,), generator=g)])
    ej = torch.cat([torch.arange(1, K), torch.arange(2, K), torch.randint(0, K, (2000,), generator=g)])
    rel = sim3.compose(gt[ej], sim3.inverse(gt[ei]))
    E = len(ei)
    p = pose_graph.PoseGraphProblem(
        vertices=sim3.compose(sim3.exp(torch.randn(K, 7, generator=g) * 0.05), gt),
        v_fixed=torch.arange(K) == 0, v_valid=torch.ones(K, dtype=torch.bool),
        edge_i=ei.to(torch.int32), edge_j=ej.to(torch.int32),
        edge_Sji=sim3.compose(sim3.exp(torch.randn(E, 7, generator=g) * 0.02), rel),
        edge_weight=torch.rand(E, generator=g) + 0.5,
        edge_valid=ei != ej)
    p = pose_graph.PoseGraphProblem(*(x.to(cuda) for x in p))
    _same_each_time(lambda: [pose_graph.gn_step(p, p.vertices, pcg_iters=50)])
    word = torch.randint(-1, 500, (2000,), generator=g).to(cuda)
    weight = torch.rand(2000, generator=g).to(cuda)
    q_word, q_weight = _same_each_time(lambda: database.aggregate_bow_dev(word, weight, 2000))
    kf_word = torch.randint(-1, 500, (64, 300), generator=g).to(cuda)
    kf_weight = torch.rand(64, 300, generator=g).to(cuda)
    _same_each_time(lambda: database._score_all(
        q_word.to(cuda), q_weight.to(cuda), kf_word, kf_weight,
        torch.ones(64, dtype=torch.bool, device=cuda), 500))
