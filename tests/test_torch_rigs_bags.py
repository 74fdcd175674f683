"""The rigs' recordings against the JAX package's tools: the Ouster and
Hesai XT32 PointCloud2 bags (chip_smoke.py's field layouts, on
the ntu_viral and hilti22 yamls' topics) written by the port's
io/rosbag.write_bag byte for byte as by the JAX writer, and converted by
`python -m fast_livo2_tpu_torch.convert_rosbag --lidar-type 3 / 5` array
for array as by scripts/convert_rosbag.py (both in subprocesses, with
the yamls' blind and point_filter_num); and the camera `scale` resize
of full-resolution frames (1280 x 1024 at 0.5, 2448 x 2048 at 0.25)
through both packages' io/dataset.load_sequence(cfg=), with the yamls'
time offsets and hilti_en's decimation, array for array."""

import subprocess
import sys

import numpy as np
import pytest

from fast_livo2_tpu.io import dataset as jdataset
from fast_livo2_tpu.io import rosbag as jbag
from fast_livo2_tpu.utils.config import load_config as jax_load_config
from fast_livo2_tpu_torch.io import dataset
from fast_livo2_tpu_torch.io import rosbag as tbag
from fast_livo2_tpu_torch.utils.config import load_config
from tests.test_torch_convert import _npz_arrays
import chip_smoke as cs
from tests.test_torch_rigs import ROOT, rig_config, rig_sequence

LIDAR_RIGS = {"ntu_viral": 3, "hilti22": 5}


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """A short recording of each PointCloud2 rig (0.6 s, 4 x 100 points),
    written by both writers."""
    root = tmp_path_factory.mktemp("rig_bags")
    out = {}
    for rig in LIDAR_RIGS:
        cfg = rig_config(rig)
        msgs = cs.rig_bag_messages(rig_sequence(rig, cfg, seconds=0.6,
                                                lines=4, per_line=100), cfg, 4)
        paths = {}
        for name, mod in (("port", tbag), ("jax", jbag)):
            paths[name] = root / f"{rig}_{name}.bag"
            mod.write_bag(str(paths[name]), msgs)
        out[rig] = (cfg, paths, root)
    return out


@pytest.mark.parametrize("rig", sorted(LIDAR_RIGS))
def test_pointcloud2_bag_bytes_equal_jax_writer(bags, rig):
    cfg, paths, _ = bags[rig]
    assert cfg.preprocess.lidar_type == LIDAR_RIGS[rig]
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()


@pytest.mark.parametrize("rig", sorted(LIDAR_RIGS))
def test_pointcloud2_conversion_equals_jax_script(bags, rig):
    cfg, paths, root = bags[rig]
    c, p = cfg.common, cfg.preprocess
    outs = {}
    for name, cmd in (("port", ["-m", "fast_livo2_tpu_torch.convert_rosbag"]),
                      ("jax", [f"{ROOT}/scripts/convert_rosbag.py"])):
        outs[name] = root / f"{rig}_{name}_seq"
        r = subprocess.run(
            [sys.executable, *cmd, str(paths["port"]), str(outs[name]),
             "--lidar-type", str(p.lidar_type), "--blind", str(p.blind),
             "--filter-num", str(p.point_filter_num), "--lid-topic",
             c.lid_topic, "--imu-topic", c.imu_topic, "--img-topic",
             c.img_topic],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
    got, want = _npz_arrays(outs["port"]), _npz_arrays(outs["jax"])
    assert sorted(got) == sorted(want)
    assert len(got["scans.npz:points"]) > 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rig", ["avia", "mars_lvig", "hilti22"])
def test_scale_resize_and_offsets_equal_jax(rig, tmp_path):
    """Full-resolution frames (random, as recorded, no rendering) read
    by both packages with the rig's config: the 0.5 / 0.25 box resize,
    the time offsets and (hilti22) the 40 -> 10 Hz decimation."""
    cfg, jcfg = load_config(*cs.rig_paths(rig)), jax_load_config(*cs.rig_paths(rig))
    w, h = cfg.camera.cam_width, cfg.camera.cam_height
    rng = np.random.default_rng(3)
    n = 6
    seq = dataset.NpzSequence(
        imu_stamps=np.arange(40) / 200.0, imu_gyr=rng.normal(size=(40, 3)),
        imu_acc=rng.normal(size=(40, 3)),
        scans=[(0.05 * k, rng.normal(size=(50, 3)).astype(np.float32),
                np.linspace(0, 0.1, 50, dtype=np.float32)) for k in range(2)],
        images=[(0.025 * k, rng.integers(0, 256, (h, w), dtype=np.uint8))
                for k in range(n)])
    dataset.save_sequence(str(tmp_path), seq)
    a = dataset.load_sequence(str(tmp_path), cfg=cfg)
    b = jdataset.load_sequence(str(tmp_path), cfg=jcfg)
    keep = 4 if cfg.preprocess.hilti_en else 1
    assert len(a.images) == len(b.images) == -(-n // keep)
    s = cfg.camera.scale
    for (ta, ia), (tb, ib) in zip(a.images, b.images):
        assert ta == tb
        assert ia.dtype == ib.dtype == np.float32
        assert ia.shape == (round(h * s), round(w * s))
        np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(a.imu_stamps, b.imu_stamps)
    for (ta, pa, oa), (tb, pb, ob) in zip(a.scans, b.scans):
        assert ta == tb
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(oa, ob)
