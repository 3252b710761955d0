"""Train a BoW vocabulary artifact with the port.

Counterpart of tools/train_vocab.py. The reference loads the pretrained
ORBvoc.txt (k=10, L=6; System.cc:64), which is not in the repo; the port
ships its own vocabulary (``assets/vocab_k10_L5.npz``) trained on a
synthetic corpus rendered with the repo's generators (tests/synthetic.py):
``n_worlds`` blob worlds, ``--frames`` views of each, ORB descriptors from
the port's extractor on ``--device``, then ``bow/vocab.train_vocabulary``
and ``bow/vocab.save``.

Usage: python3 -m c_orb_slam_tpu_torch.tools.train_vocab [n_worlds] [out.npz]
           [--frames 12] [--features 2000] [--levels 8] [--k 10] [--L 5]
           [--levels-up 3] [--device cuda|cpu]

The defaults are the shipped artifact's; ``out`` defaults to it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "c_orb_slam_tpu_torch", "assets", "vocab_k10_L5.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_worlds", type=int, nargs="?", default=24)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--frames", type=int, default=12, help="views rendered per world")
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--levels", type=int, default=8, help="pyramid levels of the extractor")
    ap.add_argument("--k", type=int, default=10, help="branching factor")
    ap.add_argument("--L", type=int, default=5, help="tree depth")
    ap.add_argument("--levels-up", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_vocab: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import blob_world, render_scene, smooth_trajectory

    from c_orb_slam_tpu_torch.bow import vocab as vocab_mod
    from c_orb_slam_tpu_torch.config import OrbConfig
    from c_orb_slam_tpu_torch.ops import extract
    from c_orb_slam_tpu_torch.utils.host import fetch

    orb = OrbConfig(n_features=args.features, n_levels=args.levels)
    K4 = (500.0, 500.0, 320.0, 240.0)
    t0 = time.time()
    descs = []
    for w in range(args.n_worlds):
        xw, inten, size = blob_world(300 + 40 * (w % 7), seed=1000 + w)
        traj = smooth_trajectory(args.frames, seed=w)
        for T in traj:
            img = torch.from_numpy(render_scene(xw, inten, size, T, K4)).to(device)
            kps = extract.extract_orb(img, orb, seed=42)
            d, v = fetch(kps.desc, kps.valid)
            descs.append(d[v].view("uint32"))
        print(f"world {w + 1}/{args.n_worlds} ({time.time() - t0:.1f}s)", flush=True)
    print(f"extracted {sum(len(d) for d in descs)} descriptors from {len(descs)} images "
          f"({time.time() - t0:.1f}s)", flush=True)

    t0 = time.time()
    voc = vocab_mod.train_vocabulary(descs, k=args.k, L=args.L, levels_up=args.levels_up,
                                     seed=42, device=device)
    print(f"trained k={args.k} L={args.L} in {time.time() - t0:.1f}s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    vocab_mod.save(voc, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
