"""Pose-solve problems at the shapes of optimize_pose's callers
(optim/pose_opt.py): the fused tracking step's solve, and PnP RANSAC's
hypotheses, polish and final solve. Each returns (tensor arguments on the
CPU, keyword arguments). Used by tests/test_torch_pose_gn_cuda.py and
chip_smoke.py's phase 1; numpy and torch only.
"""

import numpy as np
import torch

from c_orb_slam_tpu_torch.geometry import camera, se3, so3

KITTI_K = (718.856, 718.856, 607.1928, 185.2157)
KITTI_BF = 386.1448


def random_pose(rng, rot=0.03, trans=0.2):
    """A (3, 4) pose within rot radians and trans metres of the identity."""
    return se3.make(so3.exp(torch.from_numpy(rng.uniform(-rot, rot, 3).astype(np.float32))),
                    torch.from_numpy(rng.uniform(-trans, trans, 3).astype(np.float32)))


def tracker_problem(seed=0, n=2000, stereo_share=0.6, outliers=0.3, bf=KITTI_BF):
    """The fused tracking step's solve: one pose, n rows of KITTI geometry
    (points 3-30 m deep in front of the rig), stereo_share of them stereo,
    a share of gross outliers, a start 2 cm / 0.6 degrees off."""
    rng = np.random.default_rng(seed)
    K = torch.tensor(KITTI_K)
    T_true = random_pose(rng)
    xc = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.3, 0.3, n), np.ones(n)], 1)
    xc *= rng.uniform(3, 30, (n, 1))
    xw = se3.apply(se3.inverse(T_true), torch.from_numpy(xc.astype(np.float32)))
    obs = camera.project_stereo(se3.apply(T_true, xw), K, bf)
    octave = rng.integers(0, 8, n)
    obs += torch.from_numpy((rng.normal(0, 1, (n, 3)) * 1.2 ** octave[:, None]).astype(np.float32))
    bad = rng.random(n) < outliers
    obs[bad, :2] += torch.from_numpy(rng.uniform(15, 80, (int(bad.sum()), 2)).astype(np.float32))
    stereo = torch.from_numpy((rng.random(n) < stereo_share) & (bf > 0))
    obs[:, 2] = torch.where(stereo, obs[:, 2], 0.0)
    T0 = se3.compose(se3.exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32))), T_true)
    return dict(T0=T0, xw=xw, obs=obs,
                inv_sigma2=torch.from_numpy((1.0 / 1.44 ** octave).astype(np.float32)),
                is_stereo=stereo, valid=torch.from_numpy(rng.random(n) > 0.05), K=K), dict(bf=bf)


def pnp_hypotheses(seed=0, B=64):
    """PnP's first round: B minimal 6-point hypotheses in normalized
    coordinates (K = identity, inv_sigma2 1e6, all rows valid), 1 x 8."""
    rng = np.random.default_rng(seed)
    xs, ns, T0 = [], [], []
    for _ in range(B):
        T = random_pose(rng, 0.2, 1.0)
        xc = np.concatenate([rng.uniform(-2, 2, (6, 2)), rng.uniform(4, 10, (6, 1))], 1)
        xs.append(se3.apply(se3.inverse(T), torch.from_numpy(xc.astype(np.float32))))
        ns.append(torch.from_numpy((xc[:, :2] / xc[:, 2:] + rng.normal(0, 1e-3, (6, 2)))
                                   .astype(np.float32)))
        T0.append(se3.compose(se3.exp(torch.from_numpy(rng.normal(0, 0.02, 6).astype(np.float32))), T))
    ns = torch.stack(ns)
    return dict(T0=torch.stack(T0), xw=torch.stack(xs),
                obs=torch.cat([ns, torch.zeros_like(ns[..., :1])], -1),
                inv_sigma2=torch.full((B, 6), 1e6), is_stereo=torch.zeros((B, 6), dtype=torch.bool),
                valid=torch.ones((B, 6), dtype=torch.bool),
                K=torch.tensor([1.0, 1.0, 0.0, 0.0])), dict(bf=0.0, rounds=1, iters=8)


def pnp_polish(seed=0, B=8, m=300):
    """PnP's polish: B poses over the same m correspondences (expanded
    points and observations, (m,) weights and flags) with a (B, m)
    consensus mask each, TUM's K, 1 x 8."""
    rng = np.random.default_rng(seed)
    K = torch.tensor([517.3, 516.5, 318.6, 255.3])
    T_true = random_pose(rng)
    xc = np.concatenate([rng.uniform(-3, 3, (m, 2)), rng.uniform(2, 8, (m, 1))], 1)
    xw = se3.apply(se3.inverse(T_true), torch.from_numpy(xc.astype(np.float32)))
    uv = camera.project(se3.apply(T_true, xw), K)
    uv += torch.from_numpy(rng.normal(0, 1, (m, 2)).astype(np.float32))
    uv[: m // 4] += 50.0
    obs3 = torch.cat([uv, torch.zeros_like(uv[:, :1])], 1)
    T0 = se3.compose(se3.exp(torch.from_numpy(rng.normal(0, 0.01, (B, 6)).astype(np.float32))),
                     T_true.expand(B, 3, 4))
    return dict(T0=T0, xw=xw.expand(B, m, 3), obs=obs3.expand(B, m, 3),
                inv_sigma2=torch.ones(m), is_stereo=torch.zeros(m, dtype=torch.bool),
                valid=torch.from_numpy(rng.random((B, m)) > 0.3), K=K), dict(bf=0.0, rounds=1,
                                                                             iters=8)


def pnp_final(seed=0):
    """PnP's last solve: one pose, 2 rounds x 10, over the winner's set."""
    a, kw = pnp_polish(seed, B=1)
    a = dict(a, T0=a["T0"][0], xw=a["xw"][0], obs=a["obs"][0], valid=a["valid"][0])
    return a, dict(kw, rounds=2, iters=10)
