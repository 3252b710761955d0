"""Dataset indexers: TUM RGB-D, KITTI odometry, EuRoC MAV.

Copies of the JAX package's indexers (c_orb_slam_tpu/datasets/), which
mirror the reference's example-driver loaders (Examples/Monocular/
mono_tum.cc:LoadImages, Examples/Stereo/stereo_kitti.cc:130-164,
Examples/Stereo/stereo_euroc.cc, Examples/RGB-D/rgbd_tum.cc) as plain
path + timestamp lists; frames are decoded by io/native."""

from c_orb_slam_tpu_torch.datasets.euroc import load_euroc  # noqa: F401
from c_orb_slam_tpu_torch.datasets.kitti import load_kitti  # noqa: F401
from c_orb_slam_tpu_torch.datasets.tum import load_tum_associations, load_tum_rgb  # noqa: F401
