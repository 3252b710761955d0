"""optimize_pose's dispatch and argument checks on the CPU (optim/pose_opt.py).

CPU tensors take the plain version, optimize_pose_reference, bit for bit,
and never count a kernel launch; every call, on either device, first
passes the checks of what the CUDA kernel (csrc/pose_gn.cu) takes. The
kernel itself is held to the plain version on the card by
tests/test_torch_pose_gn_cuda.py.
"""

import numpy as np
import pytest
import torch

from c_orb_slam_tpu_torch.geometry import camera, se3, so3
from c_orb_slam_tpu_torch.optim import pose_opt

K = torch.tensor([718.856, 718.856, 607.1928, 185.2157])
BF = 386.1448


def _problem(n=64, seed=0, batch=None):
    """A stereo/mono mix seen from a pose near the identity; with `batch`,
    that many perturbed starting poses over the same rows."""
    rng = np.random.default_rng(seed)
    xw = np.concatenate([rng.uniform(-4, 4, (n, 2)), rng.uniform(4, 12, (n, 1))], 1)
    xw = torch.from_numpy(xw.astype(np.float32))
    T_true = se3.make(so3.exp(torch.tensor([0.02, -0.01, 0.01])), torch.tensor([0.1, 0.0, 0.05]))
    obs = camera.project_stereo(se3.apply(T_true, xw), K, BF)
    obs += torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32))
    stereo = torch.from_numpy(rng.random(n) < 0.6)
    obs[:, 2] = torch.where(stereo, obs[:, 2], 0.0)
    isig = torch.from_numpy((1.0 / 1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    T0 = torch.eye(3, 4)
    if batch:
        xi = torch.from_numpy(rng.normal(0, 0.01, (batch, 6)).astype(np.float32))
        T0 = se3.compose(se3.exp(xi), T0.expand(batch, 3, 4))
    return dict(T0=T0, xw=xw, obs=obs, inv_sigma2=isig, is_stereo=stereo, valid=valid, K=K)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) or (g.isnan() == w.isnan()).all() and torch.equal(
            g[~g.isnan()], w[~w.isnan()])


@pytest.mark.parametrize("damping", [1e-5, 0.0])
def test_cpu_tensors_run_the_plain_version_and_launch_nothing(damping):
    pose_opt.reset_launches()
    a = _problem()
    if damping == 0.0:
        a["valid"] = torch.zeros_like(a["valid"])  # H = 0: the NaN pose
    got = pose_opt.optimize_pose(**a, bf=BF, damping=damping)
    want = pose_opt.optimize_pose_reference(**a, bf=BF, damping=damping)
    _assert_same(got, want)
    assert pose_opt.launches == 0
    if damping == 0.0:
        assert got.pose.isnan().all() and int(got.n_inliers) == 0


def test_batch_over_shared_rows_is_taken_as_given():
    """PnP's polish: B poses over expanded (stride 0) rows and (N,) per-row
    arrays against a (B, N) mask; the checks take the views as they are."""
    a = _problem(batch=8)
    B, n = 8, a["xw"].shape[0]
    rng = np.random.default_rng(1)
    a.update(xw=a["xw"].expand(B, n, 3), obs=a["obs"].expand(B, n, 3),
             valid=torch.from_numpy(rng.random((B, n)) > 0.2))
    assert a["xw"].stride(0) == 0
    got = pose_opt.optimize_pose(**a, bf=BF, rounds=1, iters=8)
    _assert_same(got, pose_opt.optimize_pose_reference(**a, bf=BF, rounds=1, iters=8))
    assert got.pose.shape == (B, 3, 4) and got.inliers.shape == (B, n)
    assert got.n_inliers.shape == (B,)
    assert pose_opt.launches == 0


def _broken(name):
    a = _problem(n=16)
    if name == "float64_points":
        a["xw"] = a["xw"].double()
    elif name == "float_mask":
        a["valid"] = a["valid"].float()
    elif name == "int_stereo_flags":
        a["is_stereo"] = a["is_stereo"].to(torch.int32)
    elif name == "float64_intrinsics":
        a["K"] = a["K"].double()
    elif name == "strided_intrinsics":  # (4,) view of a (4, 2) array
        a["K"] = torch.stack([a["K"], a["K"]], 1)[:, 0]
    elif name == "strided_observations":  # (N, 3) view of an (N, 4) array
        a["obs"] = torch.cat([a["obs"], a["obs"][:, :1]], 1)[:, :3]
    elif name == "strided_weights":
        a["inv_sigma2"] = a["inv_sigma2"].repeat_interleave(2)[::2]
    elif name == "points_mixed_with_meta_device":
        a["valid"] = a["valid"].to("meta")
    elif name == "intrinsics_on_meta_device":
        a["K"] = a["K"].to("meta")
    elif name == "rows_of_another_length":
        a["valid"] = a["valid"][:-1]
    elif name == "points_unbatched_under_batched_pose":
        a["T0"] = a["T0"].expand(2, 3, 4)
    elif name == "pose_of_wrong_shape":
        a["T0"] = torch.eye(4)
    return a


BROKEN = {
    "float64_points": TypeError, "float_mask": TypeError, "int_stereo_flags": TypeError,
    "float64_intrinsics": TypeError, "strided_intrinsics": ValueError,
    "strided_observations": ValueError,
    "strided_weights": ValueError, "points_mixed_with_meta_device": ValueError,
    "intrinsics_on_meta_device": ValueError, "rows_of_another_length": ValueError,
    "points_unbatched_under_batched_pose": ValueError, "pose_of_wrong_shape": ValueError,
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_checks_raise_on_what_the_kernel_does_not_take(name):
    a = _broken(name)
    with pytest.raises(BROKEN[name]):
        pose_opt.optimize_pose(**a, bf=BF)


def test_a_device_other_than_cpu_or_cuda_is_refused():
    a = {k: v.to("meta") for k, v in _problem(n=16).items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        pose_opt.optimize_pose(**a, bf=BF)


@pytest.mark.parametrize("n, threads", [(0, 32), (6, 32), (32, 32), (33, 64), (500, 512),
                                        (2000, 512), (8192, 512)])
def test_block_size_follows_the_row_count(n, threads):
    assert pose_opt.block_threads(n) == threads
