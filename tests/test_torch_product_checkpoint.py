"""Map checkpoints across the packages: the port's io/checkpoint.py against
the JAX package's, on a map filled from a seed (small capacities) and the
shipped 10^5-word vocabulary, on the CPU.

- A map saved by the port loads back in the port with every array, scalar
  and the vocabulary equal, and its device mirror, built at first use,
  holds every loaded row.
- A map saved by either package loads in the other, equal in every array
  and in the vocabulary (the port holds node descriptors as int32 with the
  bits of the file's uint32), and the two files have the same keys and
  dtypes.
- A checkpoint from before keyframe and point serials existed gets the same
  defaults in both packages.

Everything is compared exactly: nothing is computed, only copied.
"""

import numpy as np
import pytest
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.bow import vocab as jvocab
from c_orb_slam_tpu.io import checkpoint as jckpt
from c_orb_slam_tpu.slam_map.mapstate import MapState as JaxMapState
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.bow import vocab as tvocab
from c_orb_slam_tpu_torch.io import checkpoint as tckpt
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState as TorchMapState

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _cfg(mod):
    return mod.SlamConfig(
        sensor=mod.Sensor.RGBD, orb=mod.OrbConfig(n_features=300, n_levels=4),
        capacity=mod.CapacityConfig(max_keyframes=16, max_points=2048),
    )


def _fill(ms, seed):
    """Random content of every saved field, in the field's dtype."""
    rng = np.random.default_rng(seed)
    for name in tckpt._ARRAY_FIELDS:
        a = getattr(ms, name)
        if a.dtype == np.bool_:
            v = rng.random(a.shape) < 0.5
        elif np.issubdtype(a.dtype, np.floating):
            v = rng.normal(0, 3, a.shape)
        else:
            v = rng.integers(-1, 2**31 - 1 if a.dtype == np.uint32 else 1000, a.shape)
        setattr(ms, name, v.astype(a.dtype))
    ms.n_keyframes = 12
    ms.n_added_keyframes = 40
    ms.n_added_points = 5000
    ms.big_change_idx = 7
    return ms


@pytest.fixture(scope="module")
def maps():
    voc_path = tvocab.builtin_vocabulary_path()
    jms = _fill(JaxMapState(_cfg(jcfg)), 3)
    tms = _fill(TorchMapState(_cfg(tcfg), compute_device=CPU), 3)
    return (jms, jvocab.load(voc_path)), (tms, tvocab.load(voc_path))


def _assert_maps_equal(a, b):
    for name in tckpt._ARRAY_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in tckpt._SCALAR_FIELDS:
        assert int(getattr(a, name)) == int(getattr(b, name)), name


def _words(voc):
    """(k, L, levels_up, uint32 levels, valid, word weights) as numpy."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    return (voc.k, voc.L, voc.levels_up, [host(d).view(np.uint32) for d in voc.levels],
            [host(v) for v in voc.valid], host(voc.word_weight))


def _assert_vocab_equal(a, b):
    wa, wb = _words(a), _words(b)
    assert wa[:3] == wb[:3]
    for x, y in zip(wa[3] + wa[4] + [wa[5]], wb[3] + wb[4] + [wb[5]]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_port_round_trip_and_device_mirror(maps, tmp_path):
    _, (tms, tvoc) = maps
    path = str(tmp_path / "map.npz")
    tckpt.save_map(path, tms, tvoc)
    m2, voc2 = tckpt.load_map(path, _cfg(tcfg), CPU)
    _assert_maps_equal(m2, tms)
    _assert_vocab_equal(voc2, tvoc)
    assert voc2.levels[0].dtype == torch.int32 and voc2.device == CPU
    dev = m2.device
    dev.flush()
    pts = np.nonzero(m2.pt_valid)[0]
    np.testing.assert_array_equal(dev.pt_xyz.numpy()[pts], m2.pt_xyz[pts])
    np.testing.assert_array_equal(dev.pt_desc.numpy()[pts].view(np.uint32), m2.pt_desc[pts])
    kfs = np.arange(m2.n_keyframes)
    np.testing.assert_array_equal(dev.kf_desc.numpy()[kfs].view(np.uint32), m2.kf_desc[kfs])
    np.testing.assert_array_equal(dev.kf_pose.numpy()[kfs], m2.kf_pose[kfs])


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_map_saved_by_one_package_loads_in_the_other(maps, tmp_path, saved_by):
    (jms, jvoc), (tms, tvoc) = maps
    paths = {side: str(tmp_path / f"{side}.npz") for side in ("jax", "port")}
    jckpt.save_map(paths["jax"], jms, jvoc)
    tckpt.save_map(paths["port"], tms, tvoc)
    with np.load(paths["jax"]) as zj, np.load(paths["port"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert zj[key].dtype == zt[key].dtype and zj[key].shape == zt[key].shape, key
    if saved_by == "jax":
        loaded, voc = tckpt.load_map(paths["jax"], _cfg(tcfg), CPU)
    else:
        loaded, voc = jckpt.load_map(paths["port"], _cfg(jcfg))
    _assert_maps_equal(loaded, jms)
    _assert_maps_equal(loaded, tms)
    _assert_vocab_equal(voc, jvoc)


def test_pre_serial_checkpoint_defaults_match(maps, tmp_path):
    """A checkpoint without kf_serial, n_added_keyframes and pt_serial (an
    older file) gets the same serials in both packages."""
    _, (tms, _) = maps
    path = str(tmp_path / "old.npz")
    tckpt.save_map(path, tms)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k not in ("kf_serial", "n_added_keyframes", "pt_serial")}
    np.savez_compressed(path, **old)
    t_loaded, t_voc = tckpt.load_map(path, _cfg(tcfg), CPU)
    j_loaded, j_voc = jckpt.load_map(path, _cfg(jcfg))
    assert t_voc is None and j_voc is None
    _assert_maps_equal(t_loaded, j_loaded)
    np.testing.assert_array_equal(t_loaded.kf_serial[:12], np.arange(12))
    assert t_loaded.n_added_keyframes == 12
