"""Parity of the port's frontend (pyramid, FAST, orientation, rBRIEF,
build_rgbd) with the JAX package's, on rendered 640x480 frames on the CPU.

Tolerances and why:
- resize weights, 1e-6: the port rebuilds jax.image.resize's
  antialiased-bilinear weights in numpy with the arithmetic XLA's CPU
  compiler emits (fused multiply-add sample positions, folded
  reciprocal); the column normalisation still sums in another order.
- pyramid levels, 1e-3 intensity units: the resize is two float32 matmuls
  whose summation order differs between XLA and PyTorch (hazard c).
- blur and level-0 FAST: exact (same float32 / bfloat16 elementwise ops
  in the same order; FAST runs in bf16 on both sides, hazard d).
- build_rgbd: keypoint sets agree to >= 99%. Level-0 descriptors are
  >= 99% bit-identical: the rest differ only where a 1e-6 rad difference
  in the orientation moves a rotated sample across a pixel boundary.
  On resized levels a descriptor is NOT bit-identical: rendered frames
  have flat patches of equal intensity, and the ~1e-4 difference of the
  resized level decides ``a < b`` between pixels that were equal. There
  the gate is a mean Hamming distance <= 4 of 256 bits, 99th percentile
  <= 24, far inside the matchers' TH_LOW = 50.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.frontend import frame as jframe
from c_orb_slam_tpu.ops import brief as jbrief, extract as jextract, fast as jfast
from c_orb_slam_tpu.ops import orient as jorient, pyramid as jpyr
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.frontend import frame as tframe
from c_orb_slam_tpu_torch.ops import brief as tbrief, extract as textract, fast as tfast
from c_orb_slam_tpu_torch.ops import orient as torient, pyramid as tpyr

from synthetic import blob_world, render_depth, render_scene, render_stereo_pair, smooth_trajectory

K4 = (500.0, 500.0, 320.0, 240.0)


@pytest.fixture(scope="module")
def frame():
    """One rendered TUM-geometry RGB-D frame, image as uint8 values."""
    xw, inten, size = blob_world(400, seed=5)
    T = smooth_trajectory(60, speed=0.4)[7]
    img = np.clip(render_scene(xw, inten, size, T, K4), 0, 255).astype(np.uint8)
    return img.astype(np.float32), render_depth(xw, size, T, K4)


@pytest.mark.parametrize("in_size,out_size", [(480, 400), (640, 533), (480, 278), (640, 214)])
def test_resize_weights_match_jitted_jax(in_size, out_size):
    eye = jnp.eye(in_size, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda x: jax.image.resize(x, (out_size, in_size), "bilinear"))(eye))
    np.testing.assert_allclose(tpyr.resize_weights(in_size, out_size), want, atol=1e-6, rtol=0)


def test_pyramid_and_blur_match_jax(frame):
    img = frame[0]
    lj = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    lt = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    assert [tuple(x.shape) for x in lt] == [x.shape for x in lj]
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        tpyr.gaussian_blur(lt[2]).numpy(), np.asarray(jpyr.gaussian_blur(jnp.asarray(lt[2].numpy())))
    )


def test_fast_orient_brief_match_jax_on_one_level(frame):
    """Level 0 (identical input on both sides): the score map, selection
    and descriptors agree exactly."""
    img = frame[0]
    sj = jfast.detect(jnp.asarray(img), 20.0, 7.0, border=16, cell=30)
    st = tfast.detect(torch.from_numpy(img), 20.0, 7.0, border=16, cell=30)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    yx_j, r_j, v_j = jextract.select_keypoints(sj, 200, 30)
    yx_t, r_t, v_t = textract.select_keypoints(st, 200, 30)
    for a, b in ((yx_t, yx_j), (r_t, r_j), (v_t, v_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        textract.subpixel_refine(st, yx_t).numpy(), np.asarray(jextract.subpixel_refine(sj, yx_j)),
        atol=1e-6,
    )
    ang_t = torient.ic_angle(torch.from_numpy(img), yx_t, 15)
    ang_j = jorient.ic_angle(jnp.asarray(img), yx_j, 15)
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-5)
    # Same angles into both samplers: the descriptors are bit-identical.
    blurred = jpyr.gaussian_blur(jnp.asarray(img))
    dj = np.asarray(jbrief.compute_descriptors(blurred, yx_j, ang_j, 42))
    dt = tbrief.compute_descriptors(torch.from_numpy(np.array(blurred)), yx_t,
                                    torch.from_numpy(np.array(ang_j)), 42)
    np.testing.assert_array_equal(dt.numpy().view(np.uint32), dj)


def _keymap(f):
    return {
        (round(float(x), 3), round(float(y), 3), int(o)): i
        for i, (x, y, o) in enumerate(zip(f.xy_raw[:, 0], f.xy_raw[:, 1], f.octave))
        if f.valid[i]
    }


def test_build_rgbd_matches_jax(frame):
    img, depth = frame
    kw = dict(sensor=2, camera=dict(bf=100.0), orb=dict(n_features=1000, n_levels=8))

    def cfg(mod):
        return mod.SlamConfig(
            sensor=kw["sensor"], camera=mod.CameraConfig(**kw["camera"]),
            orb=mod.OrbConfig(**kw["orb"]),
        )

    fj = jframe.FrameData(*(np.asarray(x) for x in jframe.build_rgbd(
        jnp.asarray(img), jnp.asarray(depth), cfg(jcfg))))
    ft = tframe.FrameData(*(x.numpy() for x in tframe.build_rgbd(
        torch.from_numpy(img), torch.from_numpy(depth), cfg(tcfg))))
    kj, kt = _keymap(fj), _keymap(ft)
    common = sorted(set(kj) & set(kt))
    assert len(common) >= 0.99 * len(kj) and len(kj) > 900
    ij = np.array([kj[k] for k in common])
    it = np.array([kt[k] for k in common])
    for field in ("xy", "angle", "ur", "depth"):
        np.testing.assert_allclose(getattr(ft, field)[it], getattr(fj, field)[ij], atol=1e-4)
    hd = np.bitwise_count(fj.desc[ij] ^ ft.desc[it].view(np.uint32)).sum(-1)
    level0 = fj.octave[ij] == 0
    assert (hd[level0] == 0).mean() >= 0.99
    assert hd.mean() <= 4 and np.percentile(hd, 99) <= 24



def test_build_stereo_matches_jax():
    """One rendered rectified pair (baseline 0.2 m): on the keypoints both
    sides share, the stereo-match masks agree on >= 99% and ur and depth
    within 1e-3 px / 1e-3 m where both matched. The masks may part where a
    SAD minimum or the median-SAD trim sits on a float32 tie of the
    resized levels."""
    xw, inten, size = blob_world(400, seed=5)
    T = smooth_trajectory(60, speed=0.4)[7]
    left, right = (np.clip(x, 0, 255).astype(np.uint8).astype(np.float32)
                   for x in render_stereo_pair(xw, inten, size, T, K4, 0.2))

    def cfg(mod):
        return mod.SlamConfig(sensor=1, camera=mod.CameraConfig(bf=100.0),
                              orb=mod.OrbConfig(n_features=1000, n_levels=8))

    fj = jframe.FrameData(*(np.asarray(x) for x in jframe.build_stereo(
        jnp.asarray(left), jnp.asarray(right), cfg(jcfg))))
    ft = tframe.FrameData(*(x.numpy() for x in tframe.build_stereo(
        torch.from_numpy(left), torch.from_numpy(right), cfg(tcfg))))
    kj, kt = _keymap(fj), _keymap(ft)
    common = sorted(set(kj) & set(kt))
    assert len(common) >= 0.99 * len(kj)
    ij = np.array([kj[k] for k in common])
    it = np.array([kt[k] for k in common])
    gj, gt = fj.depth[ij] > 0, ft.depth[it] > 0
    assert (gj == gt).mean() >= 0.99 and gj.sum() > 200
    both = gj & gt
    np.testing.assert_allclose(ft.ur[it][both], fj.ur[ij][both], atol=1e-3)
    np.testing.assert_allclose(ft.depth[it][both], fj.depth[ij][both], atol=1e-3)
