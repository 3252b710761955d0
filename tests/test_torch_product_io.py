"""The port's product IO against the JAX package's, on the CPU: dataset
indexers, stereo rectification, the native image loader, and one run of
the RGB-D driver as a user starts it.

- Indexers: equal lists on the fake trees of tests/test_datasets.py.
- Rectification: init_undistort_rectify_map equal (the same numpy code);
  remap_bilinear and StereoRectifier within 1e-4 of the JAX remap
  (float32 bilinear weights, another order of operations).
- Decoding: PNG, PGM and JPEG equal to the JAX loader's gray read (both
  build the same decoders from the same libraries). The port's raw read
  keeps a 16-bit value of 5000 (1 m in a TUM depth PNG) as 5000.0, where
  the JAX loader gives 19.0 (native: the high byte) or 19.455 (PIL:
  rescaled to [0, 255]); this difference is the point of the raw read.
  Without the native library (a build without libpng's headers) the same
  PNG goes through PIL and still reads 5000.0, via decode_raw and the
  raw Prefetcher alike.
- The RGB-D driver, `python3 -m c_orb_slam_tpu_torch.examples.rgbd_tum
  --device cpu`, on an 8-frame 320x240 TUM tree (8-bit P5 images, 16-bit
  PNG depth at 5000 per metre): all 8 frames in the saved TUM trajectory,
  ATE < 0.05 m at absolute scale, and the saved map loads. Without a CUDA
  device the default `--device cuda` ends the run with a message naming
  `--device cpu`.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from c_orb_slam_tpu import datasets as jdata
from c_orb_slam_tpu.frontend import rectify as jrect
from c_orb_slam_tpu.io.native import loader as jloader
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch import datasets as tdata
from c_orb_slam_tpu_torch.examples import rgbd_tum
from c_orb_slam_tpu_torch.frontend import rectify as trect
from c_orb_slam_tpu_torch.io import checkpoint as tckpt
from c_orb_slam_tpu_torch.io import trajectory as ttraj
from c_orb_slam_tpu_torch.io.images import write_pgm, write_tum_rgbd_tree
from c_orb_slam_tpu_torch.io.native import loader as tloader

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(d, files):
    for rel, text in files.items():
        p = d / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def test_indexers_match_jax(tmp_path):
    kitti, tum, euroc = tmp_path / "kitti", tmp_path / "tum", tmp_path / "euroc"
    _tree(kitti, {"times.txt": "".join(f"{i * 0.1:.6e}\n" for i in range(10))})
    _tree(tum, {
        "rgb.txt": "# color images\n# file\n# timestamp filename\n"
                   + "".join(f"13050312{i:02d}.342 rgb/{i}.png\n" for i in range(5)),
        "assoc.txt": "".join(f"1.{i} rgb/{i}.png 1.{i}1 depth/{i}.png\n" for i in range(5)),
    })
    for cam in ("cam0", "cam1"):
        # the right camera misses frame 3: pair matching must drop it
        rows = [f"140363679{i}000000000,{i}.png\n" for i in range(6) if cam == "cam0" or i != 3]
        _tree(euroc, {f"{cam}/data.csv": "#timestamp [ns],filename\n" + "".join(rows)})
    calls = [
        ("load_kitti", (str(kitti),)), ("load_kitti", (str(kitti), False)),
        ("load_tum_rgb", (str(tum),)),
        ("load_tum_associations", (str(tum), str(tum / "assoc.txt"))),
        ("load_euroc", (str(euroc),)), ("load_euroc", (str(euroc), False)),
    ]
    for name, args in calls:
        assert getattr(tdata, name)(*args) == getattr(jdata, name)(*args), name
    stamps, left, right = tdata.load_euroc(str(euroc))
    assert len(stamps) == 5 and not any("3.png" in p for p in left)


def test_rectification_matches_jax():
    K = np.array([[500.0, 0, 64], [0, 500.0, 48], [0, 0, 1]])
    R = np.array([[0.999, -0.02, 0.03], [0.02, 0.999, 0.01], [-0.03, -0.01, 0.999]])
    P = np.array([[480.0, 0, 60, -24.0], [0, 480.0, 50, 0], [0, 0, 1, 0]])
    D = [-0.28, 0.07, 2e-4, 1.8e-5, 0.0]
    m = trect.init_undistort_rectify_map(K, D, R, P, (128, 96))
    np.testing.assert_array_equal(m, jrect.init_undistort_rectify_map(K, D, R, P, (128, 96)))
    img = np.random.default_rng(0).uniform(0, 255, (96, 128)).astype(np.float32)
    got = trect.remap_bilinear(torch.from_numpy(img), torch.from_numpy(m)).numpy()
    want = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # The border clamp: a map far outside the image reads the clamped edge.
    far = np.full((4, 4, 2), -50.0, np.float32)
    np.testing.assert_allclose(
        trect.remap_bilinear(torch.from_numpy(img), torch.from_numpy(far)).numpy(),
        np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(far))), atol=1e-4)
    side = dict(K=K, D=np.asarray(D), R=R, P=P)
    t_l, t_r = trect.StereoRectifier(side, side, (128, 96), torch.device("cpu"))(img, img[::-1])
    j_l, j_r = jrect.StereoRectifier(side, side, (128, 96))(img, img[::-1].copy())
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), atol=1e-4)
    np.testing.assert_allclose(t_r.numpy(), np.asarray(j_r), atol=1e-4)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, fmt in enumerate(["png", "jpeg", "pgm"] * 2):
        arr = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        p = str(d / f"img_{i:03d}.{fmt}")
        if fmt == "pgm":
            write_pgm(p, arr)
        else:
            Image.fromarray(arr, "L").save(p, format=fmt.upper())
        paths.append(p)
    p = str(d / "img_rgb.png")
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), "RGB").save(p)
    return paths + [p]


def test_decoding_matches_jax_loader(image_files):
    assert tloader.native_decoders() == ["pnm", "png", "jpeg"]
    for p in image_files:
        np.testing.assert_array_equal(tloader.decode_gray(p), jloader.decode_gray(p), err_msg=p)
    with tloader.Prefetcher(image_files, n_threads=3, ahead=2) as pf:
        got = list(pf)
    assert [i for i, _ in got] == list(range(len(image_files)))
    for (_, img), p in zip(got, image_files):
        np.testing.assert_array_equal(img, jloader.decode_gray(p))


def test_16bit_depth_reads_at_full_value(tmp_path):
    depth = np.full((12, 16), 5000, np.uint16)
    depth[3, 4] = 65535
    png, pgm = str(tmp_path / "d.png"), str(tmp_path / "d.pgm")
    Image.fromarray(depth).save(png)
    write_pgm(pgm, depth)
    for p in (png, pgm):
        np.testing.assert_array_equal(tloader.decode_raw(p), depth.astype(np.float32))
        with tloader.Prefetcher([p, p], raw=True) as pf:
            for _, img in pf:
                np.testing.assert_array_equal(img, depth.astype(np.float32))
    # The JAX package's reads of the same file (a documented difference):
    # the native PNG decoder keeps the high byte, PIL rescales to [0, 255].
    assert jloader.decode_gray(png)[0, 0] == 19.0
    np.testing.assert_allclose(jloader._decode_pil(png)[0, 0], 5000 * 255 / 65535, rtol=1e-6)
    np.testing.assert_allclose(tloader.decode_gray(png)[0, 0], 5000 * 255 / 65535, rtol=1e-6)


def test_16bit_png_depth_through_pil_without_native(tmp_path, monkeypatch):
    # A machine without libpng's headers builds a PNM-only library: a TUM
    # depth PNG then goes through PIL (mode "I;16", or "I" in older PIL).
    depth = np.full((12, 16), 5000, np.uint16)
    depth[3, 4] = 65535
    png = str(tmp_path / "d.png")
    Image.fromarray(depth).save(png)
    monkeypatch.setattr(tloader, "_get_lib", lambda: None)
    got = tloader.decode_raw(png)
    assert got.dtype == np.float32 and got[0, 0] == 5000.0 and got[3, 4] == 65535.0
    np.testing.assert_array_equal(got, depth.astype(np.float32))
    with tloader.Prefetcher([png, png], raw=True) as pf:
        assert pf._handle is None
        for _, img in pf:
            np.testing.assert_array_equal(img, depth.astype(np.float32))
    np.testing.assert_allclose(tloader.decode_gray(png)[0, 0], 5000 * 255 / 65535, rtol=1e-6)


def test_a_build_that_does_not_load_is_rebuilt(tmp_path, monkeypatch):
    # A library newer than its source that does not load here (one built
    # on another machine, against libraries this one lacks) is rebuilt.
    stale = tmp_path / "libcosl_image.so"
    stale.write_bytes(b"not a shared object")
    monkeypatch.setattr(tloader, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tloader, "_LIB", None)
    monkeypatch.setattr(tloader, "_LIB_TRIED", False)
    assert "pnm" in tloader.native_decoders()
    assert "does not load" in tloader.build_log and stale.read_bytes()[:4] == b"\x7fELF"


def test_unreadable_file_raises(tmp_path, monkeypatch):
    p = tmp_path / "not_an_image.png"
    p.write_bytes(b"plain text")
    with pytest.raises(OSError):
        tloader.decode_gray(str(p))

    def no_pil(path, raw=False):
        raise ImportError("PIL")

    monkeypatch.setattr(tloader, "_decode_pil", no_pil)
    with pytest.raises(OSError, match="PIL is not installed"):
        tloader.decode_raw(str(p))


W, H, F = 320, 240, 250.0
K4 = (F, F, W / 2, H / 2)
SETTINGS = f"""%YAML:1.0
Camera.fx: {F}
Camera.fy: {F}
Camera.cx: {W / 2}
Camera.cy: {H / 2}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 10.0
Camera.bf: {F * 0.2}
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 400
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
Tracking.minStereoInitPoints: 60
Tracking.velocityRotationFraction: 0.5
"""


def test_rgbd_driver_runs_from_disk(tmp_path):
    seq = tmp_path / "seq"
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(8)
    assoc = write_tum_rgbd_tree(
        str(seq),
        [np.clip(render_scene(xw, inten, size, T, K4, h=H, w=W), 0, 255).astype(np.uint8)
         for T in traj],
        [np.round(render_depth(xw, size, T, K4, h=H, w=W) * 5000).astype(np.uint16)
         for T in traj],
        [i * 0.1 for i in range(8)])
    (tmp_path / "settings.yaml").write_text(SETTINGS)
    out, kf_out, map_out = tmp_path / "traj.txt", tmp_path / "kf.txt", tmp_path / "map.npz"
    r = subprocess.run(
        [sys.executable, "-m", "c_orb_slam_tpu_torch.examples.rgbd_tum",
         str(tmp_path / "settings.yaml"), str(seq), "--associations", assoc,
         "--out", str(out), "--kf-out", str(kf_out), "--no-realtime", "--device", "cpu",
         "--save-map", str(map_out)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "median tracking time" in r.stdout
    rows = np.loadtxt(str(out))
    assert rows.shape == (8, 8), rows.shape  # TUM: stamp, t (3), q (4)
    ids = np.round(rows[:, 0] * 10).astype(int)
    # ATE reads camera centres only: a pose [I | -c] has centre c.
    poses = np.concatenate([np.tile(np.eye(3), (8, 1, 1)), -rows[:, 1:4, None]], axis=2)
    ate = ttraj.ate_rmse(poses, traj[ids], with_scale=False)
    assert ate < 0.05, f"driver trajectory ATE {ate:.4f} m"
    cfg = tcfg.load_yaml(str(tmp_path / "settings.yaml"), tcfg.Sensor.RGBD)
    m, voc = tckpt.load_map(str(map_out), cfg, torch.device("cpu"))
    assert len(m.live_keyframes()) >= 1 and voc is not None and voc.n_words == 10**5


def test_driver_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "settings.yaml").write_text(SETTINGS)
    (tmp_path / "assoc.txt").write_text("0.0 rgb/0.pgm 0.0 depth/0.png\n")
    with pytest.raises(SystemExit, match="--device cpu"):
        rgbd_tum.main([str(tmp_path / "settings.yaml"), str(tmp_path),
                       "--associations", str(tmp_path / "assoc.txt")])
