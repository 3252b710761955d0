"""RGB-D TUM driver (reference: Examples/RGB-D/rgbd_tum.cc). Depth is read
at its stored 16-bit value and scaled by the settings' DepthMapFactor.

Usage: python3 -m c_orb_slam_tpu_torch.examples.rgbd_tum <settings.yaml> <sequence_dir> --associations <file>
"""

from c_orb_slam_tpu_torch.config import Sensor, load_yaml
from c_orb_slam_tpu_torch.datasets import load_tum_associations
from c_orb_slam_tpu_torch.examples.common import run_sequence, standard_parser


def main(argv=None):
    p = standard_parser(__doc__)
    p.add_argument("--associations", required=True)
    args = p.parse_args(argv)
    cfg = load_yaml(args.settings, Sensor.RGBD)
    stamps, rgb, depth = load_tum_associations(args.sequence, args.associations)
    return run_sequence(cfg, stamps, rgb, depth_paths=depth, args=args)


if __name__ == "__main__":
    main()
