"""The port's vocabulary command lines, run as a user runs them.

``convert_orbvoc`` on a small ragged DBoW2 text that the test writes (the
repo holds no ORBvoc.txt): its npz loads, through the port's
``bow.vocab.load``, to the tree and weights that the JAX package's
``load_dbow2_text`` gives for the same text. ``train_vocab`` end to end on
the smallest corpus its arguments allow: it writes an npz the port loads
and that describes keyframes.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from c_orb_slam_tpu.bow import vocab as jvoc
from c_orb_slam_tpu_torch.bow import vocab as tvoc

from test_torch_bow import _assert_same_voc, _write_dbow2_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args, timeout=120):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_convert_orbvoc_matches_jax(tmp_path):
    txt, npz = str(tmp_path / "voc.txt"), str(tmp_path / "voc.npz")
    _write_dbow2_text(txt, np.random.default_rng(7))
    r = _run("c_orb_slam_tpu_torch.tools.convert_orbvoc", txt, npz, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "k=3 L=3 words=27" in r.stdout
    _assert_same_voc(jvoc.load_dbow2_text(txt), tvoc.load(npz))  # levels_up 4, as the JAX tool
    # Without a card the default device refuses, rather than falling back.
    if not torch.cuda.is_available():
        r = _run("c_orb_slam_tpu_torch.tools.convert_orbvoc", txt, npz)
        assert r.returncode == 1 and "no CUDA device" in r.stderr


def test_train_vocab_end_to_end(tmp_path):
    out = str(tmp_path / "tiny.npz")
    r = _run("c_orb_slam_tpu_torch.tools.train_vocab", "2", out, "--frames", "2",
             "--features", "300", "--levels", "2", "--k", "8", "--L", "2", "--levels-up", "1",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    voc = tvoc.load(out)
    assert (voc.k, voc.L, voc.levels_up, voc.n_words) == (8, 2, 1, 64)
    # idf over the 4 images: a word that misses an image weighs > 0.
    assert bool(voc.valid[-1].any()) and float(voc.word_weight.max()) > 0
    # The trained tree describes a random descriptor set.
    d = torch.from_numpy(np.random.default_rng(0).integers(0, 2**32, (50, 8), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))
    fb = tvoc.transform(voc, d, torch.ones(50, dtype=torch.bool))
    assert int(fb.word.min()) >= 0 and int(fb.word.max()) < 64
