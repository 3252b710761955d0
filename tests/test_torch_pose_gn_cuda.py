"""The pose-solve kernel on the card: csrc/pose_gn.cu, launched by
optim/pose_opt.py::optimize_pose on CUDA tensors, against
optimize_pose_reference on the same CUDA tensors. Marked ``cuda``;
skipped where no GPU is visible. Run them on the GPU with
``python -m pytest --noconftest tests/test_torch_pose_gn_cuda.py``.

Tolerances: both sides iterate float32 Gauss-Newton on the same rows, but
sum the normal equations in another order (a fixed tree in the kernel,
cuBLAS in the plain version) and solve them by another elimination, so
poses agree to 1e-4 (relative, and absolute near 0). An inlier flag may
differ only on a row whose chi2 lies within 1e-3 (relative) of its gate.
"""

import numpy as np
import pytest
import torch

from c_orb_slam_tpu_torch.optim import pose_opt
from pose_problems import KITTI_BF, pnp_final, pnp_hypotheses, pnp_polish, tracker_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    return torch.device("cuda", 0)


CASES = {
    "tracker_2000_stereo_mono": lambda: tracker_problem(0),
    "tracker_2000_mono_only": lambda: tracker_problem(1, bf=0.0),
    "tracker_1337_rows": lambda: tracker_problem(2, n=1337),
    "pnp_hypotheses_64x6": lambda: pnp_hypotheses(0),
    "pnp_polish_8_over_shared_rows": lambda: pnp_polish(0),
    "pnp_final_2x10": lambda: pnp_final(0),
}


def _on(a, dev):
    return {k: v.to(dev) for k, v in a.items()}


def _chi2_ratio(a, kw, pose):
    """chi2 / gate of every row at `pose` (the plain version's arithmetic)."""
    r, _, _ = pose_opt.res.residual_and_jacobians(pose, a["xw"], a["obs"], a["K"], kw["bf"],
                                                  a["is_stereo"])
    gate = torch.where(a["is_stereo"], 7.815, 5.991)
    return (pose_opt.res.chi2(r, a["inv_sigma2"]) / gate).cpu().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    a, kw = CASES[case]()
    a = _on(a, cuda)
    before = pose_opt.launches
    got = pose_opt.optimize_pose(**a, **kw)
    torch.cuda.synchronize()
    assert pose_opt.launches == before + 1
    want = pose_opt.optimize_pose_reference(**a, **kw)
    assert got.pose.shape == want.pose.shape and got.inliers.shape == want.inliers.shape
    np.testing.assert_allclose(got.pose.cpu().numpy(), want.pose.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    gi, wi = got.inliers.cpu().numpy(), want.inliers.cpu().numpy()
    differ = gi != wi
    if differ.any():
        near = np.abs(_chi2_ratio(a, kw, want.pose) - 1.0) <= 1e-3
        assert not (differ & ~np.broadcast_to(near, differ.shape)).any(), case
    np.testing.assert_array_equal(got.n_inliers.cpu().numpy(), gi.sum(-1))
    assert wi.sum() > 0


def test_zero_damping_without_a_valid_row_gives_a_nan_pose(cuda):
    a, kw = tracker_problem(3, n=50)
    a = _on(dict(a, valid=torch.zeros(50, dtype=torch.bool)), cuda)
    got = pose_opt.optimize_pose(**a, **kw, damping=0.0)
    want = pose_opt.optimize_pose_reference(**a, **kw, damping=0.0)
    assert got.pose.isnan().all() and want.pose.isnan().all()
    assert not got.inliers.any() and int(got.n_inliers) == 0


@pytest.mark.parametrize("case", ["tracker_2000_stereo_mono", "pnp_polish_8_over_shared_rows"])
def test_two_launches_give_the_same_bits(cuda, case):
    a, kw = CASES[case]()
    a = _on(a, cuda)
    runs = [pose_opt.optimize_pose(**a, **kw) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_every_call_launches_once(cuda):
    a, kw = _on(tracker_problem(4, n=300)[0], cuda), dict(bf=KITTI_BF)
    pose_opt.reset_launches()
    for i in range(3):
        pose_opt.optimize_pose(**a, **kw)
        assert pose_opt.launches == i + 1


def test_a_tensor_scalar_is_refused_on_the_kernel_path(cuda):
    a, _ = tracker_problem(5, n=40)
    with pytest.raises(TypeError, match="Python number"):
        pose_opt.optimize_pose(**_on(a, cuda), bf=torch.tensor(KITTI_BF, device=cuda))
