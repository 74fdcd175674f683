"""The four sensor rigs the repo ships (configs/: avia + camera_pinhole,
ntu_viral + camera_ntu_viral, hilti22 + camera_fisheye_hilti22,
mars_lvig + camera_mars_lvig), each assembled as that rig records it by
chip_smoke.py's rig assembly (RIGS, rig_sequence, rig_frames,
rig_bag_messages: one copy, which the card's rigs phase runs at the
rigs' published sizes and these tests at a smaller one), and the checks
of that assembly that need no pipeline run. The per-rig parity runs
(both packages' LIVOPipeline on one rig's sequence) are in
tests/test_torch_rigs_<rig>.py and take their sequence from `rig_run`
here.

The rigs with a bag (avia: Livox CustomMsg; ntu_viral: Ouster
PointCloud2; hilti22: Hesai XT32 PointCloud2; mono8 images and Imu on
the yaml's topics) go through the port's io/rosbag.write_bag and
convert_rosbag.build_sequence with the yaml's lidar type, blind and
point_filter_num; mars_lvig is saved as an npz sequence. The yamls are
used as shipped, except, at the CPU tests' size, the capacities
(`shrink`) and the camera, rendered at its processed size
(`processed_camera`: scale 1.0, the intrinsics pre-scaled).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fast_livo2_tpu_torch import convert_rosbag as tconv
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import dataset, synthetic
from fast_livo2_tpu_torch.io import rosbag as tbag
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS_TOL_M, ROT_TOL = 8e-3, 4e-3  # tests/test_golden_trace.py

# Each rig's LiDAR pattern at the CPU tests' size (lines x points; the
# rest of each rig, chip_smoke.RIGS). 12 x 500 points a scan where the
# run is stable at it; avia and hilti22 keep more of their own patterns
# (24 x 1,000, 32 x 1,000), as at 12 x 500 their runs are chaotic: the
# JAX package against itself with every scan point moved by one ulp
# parts by 1.4 cm (avia) and its hilti22 run loses the map (ATE 7 cm; a
# 0.4 m voxel collects too few points a scan).
PATTERNS = {"avia": (24, 1000), "ntu_viral": (12, 500),
            "hilti22": (32, 1000), "mars_lvig": (12, 500)}
SECONDS = 2.0  # the CPU tests' run


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small ops a frame: with the suite's parallel workers
    each holding a full intra-op thread pool, the pools oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def processed_camera(cfg):
    """The camera at its processed size: scale 1.0 with the scale folded
    into the size and intrinsics (models/camera.make_camera's rounding)."""
    c, s = cfg.camera, cfg.camera.scale
    c.cam_width, c.cam_height = round(c.cam_width * s), round(c.cam_height * s)
    c.cam_fx, c.cam_fy, c.cam_cx, c.cam_cy = (
        c.cam_fx * s, c.cam_fy * s, c.cam_cx * s, c.cam_cy * s)
    c.scale = 1.0
    return cfg


def shrink(cfg):
    """Capacities for a 2 s run on the CPU: the shipped scan sizes (32,768
    points in, 8,192 after downsampling), smaller maps, pool and ring."""
    cfg.tpu.max_points_per_scan = 32768
    cfg.tpu.max_points_down = 8192
    cfg.tpu.hash_capacity_log2 = 15
    cfg.tpu.vis_point_capacity = 8192
    cfg.tpu.frame_ring = 32
    return cfg


def rig_config(rig, loader=load_config):
    """The rig's pair through `loader` (either package's load_config) at
    the CPU tests' size."""
    return shrink(processed_camera(loader(*cs.rig_paths(rig))))


def rig_sequence(rig, cfg, seconds=SECONDS, lines=None, per_line=None):
    """chip_smoke.rig_sequence at the CPU tests' size."""
    pattern = PATTERNS[rig]
    return cs.rig_sequence(rig, cfg, seconds, lines or pattern[0],
                           per_line or pattern[1])


def convert_bag(path, cfg):
    """The port's converter over a bag, in process, with the yaml's topics,
    lidar type, blind and point_filter_num."""
    c, p = cfg.common, cfg.preprocess
    kind_of = {c.imu_topic: "imu", c.lid_topic: "lidar", c.img_topic: "image"}
    records = ((kind_of[topic], mtype,
                msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9, msg)
               for topic, mtype, _, msg in tbag.read_messages(
                   path, topics=list(kind_of)))
    return tconv.build_sequence(records, p.lidar_type, p.blind,
                                p.point_filter_num)


def rig_run(rig, root):
    """The rig's sequence at the CPU tests' size, as the run CLI reads it:
    through a bag and the converter (mars_lvig: saved directly), as an npz
    directory under `root` with the ground truth beside it. Returns the
    directory and the port's config."""
    cfg = rig_config(rig)
    seq = rig_sequence(rig, cfg)
    out = os.path.join(root, rig)
    if rig != "mars_lvig":
        bag = os.path.join(root, f"{rig}.bag")
        tbag.write_bag(bag, cs.rig_bag_messages(seq, cfg, PATTERNS[rig][0]))
        conv = convert_bag(bag, cfg)
        conv.gt = seq.gt
        seq = conv
    dataset.save_sequence(out, seq)
    return out, cfg


def port_trajectory(cfg, seq_dir, mode="livo", **tpu):
    """The port's run on the CPU (tpu.* options set): trajectory and
    pipeline."""
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    pipe = LIVOPipeline(cfg, slam_mode=mode, device="cpu")
    traj = pipe.process(dataset.load_sequence(seq_dir, cfg=cfg))
    return traj, pipe


def jax_run(cfg, seq_dir, mode="livo", capture=False):
    """The JAX package's run over the same directory, read by its own
    load_sequence(cfg=). With `capture`, the inputs and the posterior
    state of its VIO half at every VIO frame, as numpy (copied before the
    call donates them). Returns (trajectory, captures)."""
    from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
    from fast_livo2_tpu.io import dataset as jdataset

    pipe = JaxPipeline(cfg, slam_mode=mode)
    caps = []
    if capture:
        vio_half = pipe._vio_half_jit

        def spy(packed, pool, ring, vmap_state, img, pg_pack, fid):
            cap = dict(packed=np.array(packed),
                       pool=[np.array(a) for a in pool],
                       ring=[np.array(a) for a in ring],
                       vmap=[np.array(a) for a in vmap_state],
                       img=np.array(img), pg=np.array(pg_pack), fid=int(fid))
            out = vio_half(packed, pool, ring, vmap_state, img, pg_pack, fid)
            cap["post"] = np.array(out[0])
            caps.append(cap)
            return out

        pipe._vio_half_jit = spy
    return pipe.process(jdataset.load_sequence(seq_dir, cfg=cfg)), caps


def parity_runs(rig, root):
    """The rig at the CPU tests' size through the JAX package's LIVO
    pipeline (its VIO half's inputs captured at every VIO frame) and the
    port's, split and fused, each reading the same npz directory with its
    own load_sequence(cfg=). Returns dict(jax, captures, split, pipe,
    fused, seq_dir, cfg)."""
    import copy

    from fast_livo2_tpu.utils.config import load_config as jax_load_config

    seq_dir, cfg = rig_run(rig, root)
    jtraj, caps = jax_run(rig_config(rig, jax_load_config), seq_dir,
                          capture=True)
    split, pipe = port_trajectory(copy.deepcopy(cfg), seq_dir)
    fused, _ = port_trajectory(copy.deepcopy(cfg), seq_dir, fused_frame=True)
    return dict(jax=jtraj, captures=caps, split=split, pipe=pipe, fused=fused,
                seq_dir=seq_dir, cfg=cfg)


def vio_half_diffs(cfg, captures):
    """The port's VIO half (LIVOPipeline._vio_half) on the JAX run's own
    inputs at each captured frame: (max |rotation entry| diff, max
    |position| diff) of its posterior against the JAX package's, a row a
    frame. The JAX package on the CPU samples through its XLA path at
    every M; the port samples so through K2 only above 448 tracked points
    (ops/photo_iteration.clip_taps_at), and through its torch-op path
    (tpu.pallas_photo off) otherwise, so that each frame compares one
    sampling."""
    import copy

    from fast_livo2_tpu_torch.core.pipeline import ScanPoints
    from fast_livo2_tpu_torch.io import convert
    from fast_livo2_tpu_torch.ops import photo_iteration as tp

    cfg = copy.deepcopy(cfg)
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    M = pipe.vio_cfg.grid_n_width * pipe.vio_cfg.grid_n_height
    cfg.tpu.pallas_photo = tp.clip_taps_at(M)
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    out = []
    for cap in captures:
        packed, vmap = convert.state_from_numpy(cap["packed"], *cap["vmap"],
                                                device="cpu")
        pipe.pool = convert.pool_from_numpy(*cap["pool"], device="cpu")
        pipe.ring = convert.ring_from_numpy(*cap["ring"], device="cpu")
        pg = torch.from_numpy(cap["pg"])
        post, _, _, _ = pipe._vio_half(
            packed, torch.from_numpy(cap["img"]),
            ScanPoints(pg[:, 0:3], pg[:, 3:6], pg[:, 6:12], pg[:, 12] > 0.5),
            torch.tensor(cap["fid"], dtype=torch.int32), vmap)
        d = np.abs(post.numpy()[:12] - cap["post"][:12])
        out.append((float(d[:9].max()), float(d[9:12].max())))
    return np.array(out)


def assert_traj_close(a, b, pos_tol=POS_TOL_M, rot_tol=ROT_TOL):
    assert [t for t, _, _ in a] == [t for t, _, _ in b]
    np.testing.assert_allclose(np.array([p for _, _, p in a]),
                               np.array([p for _, _, p in b]), atol=pos_tol)
    np.testing.assert_allclose(np.array([R for _, R, _ in a]),
                               np.array([R for _, R, _ in b]), atol=rot_tol)


def assert_traj_equal(a, b):
    assert [t for t, _, _ in a] == [t for t, _, _ in b]
    for (_, Ra, pa), (_, Rb, pb) in zip(a, b):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(pa, pb)


# --------------------------------------------------------------- checks

@pytest.mark.parametrize("rig,M", [("avia", 396), ("ntu_viral", 486),
                                   ("hilti22", 432), ("mars_lvig", 378)])
def test_rig_tracked_slots(rig, M):
    """The tracked-slot count M of each shipped pair at its processed
    camera (the grid of utils/config.derive_grid), and the K2 sampling it
    selects: only ntu_viral is above the JAX package's 448-point gate."""
    from fast_livo2_tpu_torch.ops import photo_iteration as tp

    pipe = LIVOPipeline(shrink(load_config(*cs.rig_paths(rig))),
                        slam_mode="livo", device="cpu")
    cfg = pipe.vio_cfg
    assert cfg.grid_n_width * cfg.grid_n_height == M
    assert tp.clip_taps_at(M) == (rig == "ntu_viral")
    assert (pipe.cam.model == "equidistant") == (rig == "hilti22")
    assert cam_mod.has_distortion(pipe.cam)


@pytest.mark.parametrize("rig", sorted(cs.RIGS))
def test_rig_geometry(rig, tmp_path):
    """The rig assembly's recording (chip_smoke.rig_frames) maps back to
    io/synthetic's through the pipeline's own convention (p_I = R p_L +
    T) and load_sequence(cfg=)'s offsets, and its camera sees through
    R_ci / P_ci as core/pipeline.py composes them."""
    cfg = rig_config(rig)
    _, _, R_ci, P_ci = cs.rig_extrinsics(cfg)
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    np.testing.assert_allclose(pipe.Rci.numpy(), R_ci, atol=1e-6)
    np.testing.assert_allclose(pipe.Pci.numpy(), P_ci, atol=1e-6)
    seq = synthetic.make_sequence(duration=0.8, seed=0, n_lines=4,
                                  n_per_line=50, render=False)
    seq.images = [(0.1, np.zeros((2, 2), np.float32))]
    rec = cs.rig_frames(seq, cfg)
    off = cfg.time_offset
    assert abs(rec.images[0][0] + off.img_time_offset - 0.1) < 1e-12
    d = str(tmp_path / "seq")
    dataset.save_sequence(d, rec)
    back = dataset.load_sequence(d, cfg=cfg)
    np.testing.assert_allclose(back.imu_stamps, seq.imu_stamps, atol=1e-9)
    assert len(back.scans) == len(seq.scans)
    for (t, p_l, o), (u, p_i, o_i) in zip(back.scans, seq.scans):
        assert abs(t - u) < 1e-9
        np.testing.assert_array_equal(o, o_i)
        np.testing.assert_allclose(
            p_l @ pipe.ext_R.numpy().T + pipe.ext_T.numpy(), p_i, atol=1e-5)


@pytest.mark.parametrize("rig", ["ntu_viral", "hilti22"])
def test_rig_bag_converts_to_its_sequence(rig, tmp_path):
    """A short recording of the Ouster / XT32 rig through the bag and the
    converter: every scan, IMU sample and image back, the stamps restored
    by load_sequence(cfg=), the yaml's point_filter_num and blind
    applied, and (hilti22) the 40 Hz camera decimated to 10 Hz."""
    cfg = rig_config(rig)
    seq = rig_sequence(rig, cfg, seconds=0.6, lines=4, per_line=100)
    bag = str(tmp_path / "rig.bag")
    tbag.write_bag(bag, cs.rig_bag_messages(seq, cfg, 4))
    conv = convert_bag(bag, cfg)
    assert len(conv.scans) == len(seq.scans)
    assert len(conv.images) == len(seq.images)
    np.testing.assert_array_equal(conv.imu_gyr, seq.imu_gyr)
    d = str(tmp_path / "seq")
    dataset.save_sequence(d, conv)
    back = dataset.load_sequence(d, cfg=cfg)
    p = cfg.preprocess
    for (t, pts, offs), (u, q, o) in zip(back.scans, seq.scans):
        assert abs(t - (u + cfg.time_offset.lidar_time_offset)) < 1e-6
        keep = np.flatnonzero((q * q).sum(1) > p.blind ** 2)[::p.point_filter_num]
        np.testing.assert_array_equal(pts, q[keep])
        np.testing.assert_allclose(offs, o[keep], atol=1e-6)
    step = 4 if cfg.preprocess.hilti_en else 1
    assert len(back.images) == -(-len(seq.images) // step)
    for (t, im), (u, _) in zip(back.images, seq.images[::step]):
        assert abs(t - (u + cfg.time_offset.img_time_offset)) < 1e-6
        assert im.shape == (cfg.camera.cam_height, cfg.camera.cam_width)


# ------------------------------------------- one-ulp spread (a script)

def _card_recording(rig, root):
    """The card's recording of the rig (chip_smoke.make_rig's: the shipped
    yamls, RIGS' size; through its bag and the port's converter but for
    mars_lvig) as an npz directory root/base."""
    cfg = load_config(*cs.rig_paths(rig))
    seq = cs.rig_sequence(rig, cfg)
    if cs.RIGS[rig]["bag"]:
        bag = os.path.join(root, "rig.bag")
        tbag.write_bag(bag, cs.rig_bag_messages(seq, cfg,
                                                cs.RIGS[rig]["lines"]))
        conv = convert_bag(bag, cfg)
        conv.gt = seq.gt
        seq = conv
    dataset.save_sequence(os.path.join(root, "base"), seq)


def _trajectory(pkg, rig, seq_dir, card, out):
    """One LIVO run of `pkg` ("jax" or "port", on the CPU) over seq_dir
    (card: the shipped yamls; else this file's size), saved as out."""
    torch.set_num_threads(2)
    if pkg == "jax":
        import tests.conftest  # noqa: F401  (JAX on the CPU)
        from fast_livo2_tpu.utils.config import load_config as loader
    else:
        loader = load_config
    cfg = loader(*cs.rig_paths(rig)) if card else rig_config(rig, loader)
    traj = (jax_run(cfg, seq_dir)[0] if pkg == "jax"
            else port_trajectory(cfg, seq_dir)[0])
    np.savez(out, t=[t for t, _, _ in traj], p=[p for _, _, p in traj],
             R=[R for _, R, _ in traj])


def ulp_spread(rig, root, card):
    """The rig's recording (card: the card's, `_card_recording`; else this
    file's, `rig_run`) and a copy with every scan point moved by one
    float32 ulp, each run by the JAX package and the port on the CPU (in
    four processes). Prints, as one JSON line, each run's ATE and drift
    (% of the ground-truth path) and the position spread of each pair
    (max |dp| over the frames up to 2, 4 and 6 s)."""
    import json
    import subprocess
    import sys

    base, ulp = os.path.join(root, "base"), os.path.join(root, "ulp")
    if not os.path.isdir(ulp):
        if card:
            _card_recording(rig, root)
        else:
            os.replace(rig_run(rig, root)[0], base)
        cs.ulp_copy(base, ulp)
    procs = {(pkg, v): subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_rigs", "run", pkg, rig,
         os.path.join(root, v), os.path.join(root, f"{pkg}_{v}.npz"),
         str(int(card))]) for pkg in ("jax", "port") for v in ("base", "ulp")}
    for p in procs.values():
        assert p.wait() == 0
    g = np.load(os.path.join(base, "gt.npz"))
    gt = [(t, None, p) for t, p in zip(g["stamps"], g["pos"])]
    path = float(np.sum(np.linalg.norm(np.diff(g["pos"], axis=0), axis=1)))
    runs = {k: np.load(os.path.join(root, f"{k[0]}_{k[1]}.npz"))
            for k in procs}
    ate = {f"{k[0]}_{k[1]}": synthetic.ate_rmse(list(zip(r["t"], r["p"])), gt)
           for k, r in runs.items()}
    out = {"rig": rig, "card_size": card, "path_m": path, "ate_m": ate,
           "drift_pct": {k: 100.0 * v / path for k, v in ate.items()}}
    for a, b in ((("jax", "base"), ("jax", "ulp")),
                 (("port", "base"), ("port", "ulp")),
                 (("port", "base"), ("jax", "base"))):
        ra, rb = runs[a], runs[b]
        assert np.array_equal(ra["t"], rb["t"])
        dp = np.linalg.norm(ra["p"] - rb["p"], axis=1)
        since = ra["t"] - ra["t"][0]
        out[f"{a[0]}_{a[1]}_vs_{b[0]}_{b[1]}_max_dp_m"] = {
            f"to_{s}s": float(dp[since <= s].max()) for s in (2, 4, 6)}
    print(json.dumps(out))


if __name__ == "__main__":
    # python -m tests.test_torch_rigs ulp RIG DIR [card]
    import sys

    if sys.argv[1] == "run":
        _trajectory(*sys.argv[2:5], sys.argv[6] == "1", sys.argv[5])
    else:
        ulp_spread(sys.argv[2], sys.argv[3],
                   len(sys.argv) > 4 and sys.argv[4] == "card")
