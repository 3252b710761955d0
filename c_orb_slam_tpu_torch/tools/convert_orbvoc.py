"""Convert a DBoW2 text vocabulary (the reference's ORBvoc.txt) to the
port's dense npz layout.

Counterpart of tools/convert_orbvoc.py. The reference parses the ~140 MB
text at every start (System.cc:64); this converts it once into the
level-major arrays of bow/vocab.py (``load_dbow2_text``, format:
TemplatedVocabulary::loadFromTextFile, TemplatedVocabulary.h:1338-1424),
after which a load is one npz read. The repo holds no ORBvoc.txt.

Usage: python3 -m c_orb_slam_tpu_torch.tools.convert_orbvoc ORBvoc.txt [out.npz]
           [--levels-up 4] [--device cuda|cpu]

Then point the config at it:
    SlamConfig(vocabulary=VocabularyConfig(path="ORBvoc.npz"))
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst", nargs="?", default=None)
    ap.add_argument("--levels-up", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("convert_orbvoc: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    from c_orb_slam_tpu_torch.bow import vocab

    dst = args.dst or os.path.splitext(args.src)[0] + ".npz"
    print(f"parsing {args.src} (the full ORBvoc takes a few minutes)...", flush=True)
    voc = vocab.load_dbow2_text(args.src, levels_up=args.levels_up, device=device)
    print(f"k={voc.k} L={voc.L} words={voc.n_words}")
    vocab.save(voc, dst)
    print(f"written {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
