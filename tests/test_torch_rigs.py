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

`OneStep` holds the port's frame to a JAX LIVO run one step at a time
(each stage of each frame on the JAX run's own inputs); the rig files
check its gaps (`one_step_faults`, `vio_half_faults`) and pin the
frames they list as ties. As a script,

    python -m tests.test_torch_rigs step RIG [card] [k2]

prints such a run's table with each package's one-ulp twins beside it
and the census of the decisions one ulp flips (`step_table`, `census`);
RIG is a rig or `core` (bench.py's core sequence at full width).
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


def jax_run(cfg, seq_dir, mode="livo", step=None):
    """The JAX package's run over the same directory, read by its own
    load_sequence(cfg=). `step`: a OneStep (below) installed on the JAX
    pipeline before it runs. Returns (trajectory, step)."""
    from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
    from fast_livo2_tpu.io import dataset as jdataset

    pipe = JaxPipeline(cfg, slam_mode=mode)
    if step is not None:
        step.install(pipe)
    return pipe.process(jdataset.load_sequence(seq_dir, cfg=cfg)), step


# ------------------------------------------------ one step at a time

STAGES = ("lio", "vio", "map")  # a frame's stages in a one-step run
# The packed state vector's blocks (core/state.pack_state).
PACKED_BLOCKS = (("rot", 0, 9), ("pos", 9, 12), ("vel", 12, 15),
                 ("bg", 15, 18), ("ba", 18, 21), ("grav", 21, 24),
                 ("inv_expo", 24, 25), ("cov", 25, None))
# The one-step floors of the packed blocks: a frame's posterior of the
# port on the JAX run's own inputs lies within these of the JAX
# package's, but at a documented tie (ROADMAP "Known parity hazards").
# cov is relative to the JAX covariance's largest entry.
STEP_FLOORS = {"rot": 1e-5, "pos": 1e-5, "vel": 1e-4, "bg": 1e-6,
               "ba": 1e-5, "grav": 1e-5, "inv_expo": 1e-4, "cov": 5e-4}
# At a listed tie the stage keeps the bound every VIO frame had before
# the one-step floors.
TIE_FLOORS = {"rot": 1e-4, "pos": 1e-4}
# The insert's floors: stats and rec (its plane columns where the JAX
# map holds a plane) relative to each column's largest entry.
MAP_FLOORS = {"stats": 1e-5, "rec": 5e-2}
# The discrete outcomes of a stage (`stage_gaps`): a count of the items
# that differ, 0 when the two runs decided alike.
DISCRETE = ("down", "match", "matched", "n_eff", "lio_iters", "keys",
            "counts", "planes", "n_tracked", "retrieved", "warp", "n_added",
            "pool_rows", "alloc", "ring", "photo_iters")


def packed_gaps(a, b):
    """max |a - b| over each block of two packed state vectors, the cov
    block relative to b's largest |entry|."""
    out = {}
    for name, i, j in PACKED_BLOCKS:
        d = float(np.abs(np.asarray(a[i:j], np.float64) - b[i:j]).max())
        out[name] = d / float(np.abs(b[i:j]).max()) if name == "cov" else d
    return out


def rel_gap(a, b):
    """max over the last axis' columns of max |a - b| / max |b| (NaN
    equal to NaN; a column of zeros in b scales by 1)."""
    a = np.float64(a).reshape(-1, a.shape[-1])
    b = np.float64(b).reshape(-1, b.shape[-1])
    if not len(b):
        return 0.0
    both = np.isnan(a) & np.isnan(b)
    d = np.where(both, 0.0, np.abs(a - b))
    s = np.where(np.isnan(b), 0.0, np.abs(b)).max(axis=0)
    r = d.max(axis=0) / np.where(s > 0, s, 1.0)
    return float(np.nan_to_num(r, nan=np.inf).max())


def _pool_marks(point, obs):
    """A pool's discrete columns a row: the point's valid, converged,
    has-reference flags and reference index, and each observation's
    valid flag, ring slot and frame id."""
    return np.concatenate([point[:, 15:19],
                           obs[:, :, [0, 16, 17]].reshape(len(point), -1)], 1)


def _photo_decisions(errs):
    """A photometric level's decisions from the errors of the iterations
    it ran: [(error, the last accepted error, accepted)] an iteration."""
    last, out = 3e38, []
    for e in errs:
        out.append((e, last, e <= last))
        if e <= last:
            last = e
    return out


def photo_flip(ta, tb, levels):
    """Where two photometric traces (a list of errors a level, coarsest
    level first) first decide differently: (pyramid level, iteration,
    (error, last accepted error) in a, the same in b), None if they
    decide alike. An iteration that one trace ran and the other did not
    compares with (None, None)."""
    for k, (ea, eb) in enumerate(zip(ta, tb)):
        da, db = _photo_decisions(ea), _photo_decisions(eb)
        for i in range(max(len(da), len(db))):
            xa = da[i] if i < len(da) else (None, None, None)
            xb = db[i] if i < len(db) else (None, None, None)
            if xa[2] != xb[2]:
                return levels - 1 - k, i, xa[:2], xb[:2]
    return None


def stage_gaps(a, b):
    """The gaps of one stage's outputs `a` against `b` (dicts of numpy
    arrays, either package's): max |Δ| of each packed block, of the
    world points and of the pool, map stats and rec relative (rel_gap),
    and a count for each discrete outcome (DISCRETE) that differs."""
    g = {}
    if "packed" in a:
        g.update(packed_gaps(a["packed"], b["packed"]))
    if "diag" in a:
        g["n_eff"] = int(a["diag"][0] != b["diag"][0])
        g["mean_res"] = float(abs(a["diag"][1] - b["diag"][1]))
    if a.get("pg") is not None:
        pa, pb = a["pg"], b["pg"]
        g["down"] = int(np.sum(pa[:, 12] != pb[:, 12]))
        if not g["down"]:  # else the rows after the moved voxel shift
            ma, mb = np.any(pa[:, 3:6] != 0, 1), np.any(pb[:, 3:6] != 0, 1)
            g["match"] = int(np.sum(ma != mb))
            # points matched to another plane (a refit of the same plane
            # moves its normal by float noise only)
            g["matched"] = int(np.sum(ma & mb & np.any(
                np.abs(pa[:, 3:6] - pb[:, 3:6]) > 1e-3, 1)))
            g["pts_w"] = float(np.abs(pa[:, 0:3] - pb[:, 0:3]).max())
    if "keys" in a:
        g["keys"] = int(np.sum(np.any(a["keys"] != b["keys"], -1)))
        g["counts"] = int(np.sum(a["stats"][..., 0] != b["stats"][..., 0]))
        g["stats"] = rel_gap(a["stats"], b["stats"])
        ra, rb = a["rec"], b["rec"]
        g["planes"] = int(np.sum(ra[..., 0] != rb[..., 0]))
        # the plane columns where b holds a plane (solid or marginal; a
        # slot that holds none keeps an unread fit)
        pl = rb[..., 0] > 0.5
        g["rec"] = max(rel_gap(ra[..., [0, 21]], rb[..., [0, 21]]),
                       rel_gap(ra[pl][:, 1:21], rb[pl][:, 1:21]))
    if "vdiag" in a:
        g["n_tracked"] = int(a["vdiag"][0] != b["vdiag"][0])
        g["n_added"] = int(a["vdiag"][1] != b["vdiag"][1])
        g["verr"] = float(abs(a["vdiag"][2] - b["vdiag"][2]))
    if "pool" in a:
        (pa, oa, _, aa), (pb, ob, _, ab) = a["pool"], b["pool"]
        g["pool_rows"] = int(np.sum(np.any(
            _pool_marks(pa, oa) != _pool_marks(pb, ob), 1)))
        g["pool"] = float(max(np.abs(pa - pb).max(), np.abs(oa - ob).max()))
        g["alloc"] = int(aa != ab)
        g["ring"] = int(not (np.array_equal(a["ring"][0], b["ring"][0])
                             and np.array_equal(a["ring"][1], b["ring"][1])))
    if "retrieved" in a and "retrieved" in b:
        i = np.flatnonzero(a["retrieved"] != b["retrieved"])
        g["retrieved"] = len(i)
        if len(i):  # point, (search level + 1, 0 when not retrieved) each
            g["retrieved_at"] = [(int(k), int(a["retrieved"][k]),
                                  int(b["retrieved"][k])) for k in i[:4]]
    if "warp" in a and "warp" in b:
        # reference-patch entries that moved by more than a grey level
        g["warp"] = int(np.sum(np.abs(a["warp"] - b["warp"]) > 1.0))
    if "photo" in a and "photo" in b:
        f = photo_flip(a["photo"], b["photo"], len(a["photo"]))
        g["photo_iters"] = int(f is not None)
        if f is not None:
            g["photo_at"] = f
    if "lio_iters" in a and "lio_iters" in b:
        g["lio_iters"] = int(a["lio_iters"] != b["lio_iters"])
        if g["lio_iters"]:
            g["lio_iters_at"] = (a["lio_iters"], b["lio_iters"])
    return g


def flips(g):
    """The discrete outcomes that differ in a stage's gaps."""
    return sorted(k for k in DISCRETE if g.get(k))


def _ulp(a, rows=None, cols=slice(0, 3)):
    """A copy of `a` with a[rows, cols] (a vector: a[cols]) moved by one
    float32 ulp toward +inf (rows: a boolean mask, or all)."""
    a = np.array(a)
    sel = cols if a.ndim == 1 else (
        slice(None) if rows is None else rows, cols)
    a[sel] = np.nextafter(a[sel], np.float32(np.inf))
    return a


class OneStep:
    """Holds the port's frame to a JAX LIVO run one step at a time.
    Installed on a JAX pipeline (split frames, as the user's default
    runs them, with the deferred insert), it wraps `_prepare_packet`,
    `_frame_jit` (the LIO half), `_vio_half_jit` and `_map_jit` (the
    deferred insert). Each call copies its inputs to numpy before the
    JAX call donates them, makes the JAX call, then runs the port's
    counterpart (`_prepare_packet`, `_frame_step` with `first` and
    `do_map` as the JAX run had them, `_vio_half`, `_insert`) on the
    same inputs, and keeps only the gaps (`stage_gaps`): `frames` holds
    a dict a frame, {stage: gaps} for the stages "lio", "vio" and
    "map", and `packets` a pair (IMU packet equal, points packet equal)
    a packet.

    The port samples as the JAX package on the CPU does: through K2's
    plain version where K2 takes clip_taps (above 448 tracked points, and
    the equidistant camera at every M) and its torch-op path otherwise
    (tpu.pallas_photo off; ROADMAP "Sampling on the CPU at M <= 448");
    `k2` True or False sets tpu.pallas_photo instead (K2's plain version
    on a pinhole camera at M <= 448 samples as the TPU kernel does, so
    there only each package's one-ulp twin against itself compares).

    `twins`: each stage also runs in both packages on a copy of its
    inputs with one input moved by one float32 ulp (the LIO half: the
    scan points; the VIO half: the packed position; the insert: the
    world points), kept as "<stage>@jax" (the JAX package's twin
    against its own run) and "<stage>@port" (the port's against its
    own). `trace`: each stage's loop decisions come along, the LIO
    iterations, the retrieved points and each pyramid level's
    photometric errors: the port's from `PhotoTrace`, the JAX package's
    from `JaxTrace` (whose `gap` holds its programs to the run's).
    `keep`: the frame ids whose inputs are kept, as numpy, in `kept`
    ({(frame id, "lio" or "vio"): inputs}), for a pin test."""

    def __init__(self, cfg, twins=False, trace=False, keep=(), k2=None):
        import copy

        from fast_livo2_tpu_torch.ops import photo_iteration as tp

        cfg = copy.deepcopy(cfg)
        pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
        M = pipe.vio_cfg.grid_n_width * pipe.vio_cfg.grid_n_height
        cfg.tpu.pallas_photo = (tp.clip_taps_at(M, pipe.cam.model)
                                if k2 is None else k2)
        self.port = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
        self.twins, self.trace, self.keep = twins, trace, set(keep)
        self.frames, self.packets, self.kept = [], [], {}
        self.jtrace = None

    def install(self, jpipe):
        self.jpipe = jpipe
        self.j_packet = jpipe._prepare_packet
        self.j_frame = jpipe._frame_jit
        self.j_vio = jpipe._vio_half_jit
        self.j_map = jpipe._map_jit
        jpipe._prepare_packet = self._packet
        jpipe._frame_jit = self._frame
        jpipe._vio_half_jit = self._vio
        jpipe._map_jit = self._map
        if self.trace:
            self.jtrace = JaxTrace(jpipe)

    # ---- the packets

    def _packet(self, t_end, seq):
        j, p = self.jpipe, self.port
        p._packet_t0, p.last_update_time = j._packet_t0, j.last_update_time
        p.pending = list(j.pending)
        out = self.j_packet(t_end, seq)
        mine = p._prepare_packet(t_end, seq)
        self.packets.append(tuple(np.array_equal(np.asarray(a), b.numpy())
                                  for a, b in zip(out, mine)))
        return out

    # ---- the LIO half

    def _frame(self, packed, vmap, pool, ring, imu_pack, pts_pack, img,
               fid, first, use_vio, emit_pg=False, do_map=True):
        from fast_livo2_tpu_torch.core import imu as timu

        assert not use_vio  # split frames: the VIO half is its own call
        if self.port.noise is None:  # set by the JAX run's IMU init
            self.port.noise = timu.ImuNoise(*(torch.from_numpy(np.array(a))
                                              for a in self.jpipe.noise))
        static = dict(first=first, use_vio=False, emit_pg=emit_pg,
                      do_map=do_map)
        x = dict(packed=np.array(packed), vmap=np_tree(vmap),
                 imu=np.array(imu_pack), pts=np.array(pts_pack),
                 first=first, do_map=do_map, emit_pg=emit_pg)
        twin = None
        if self.twins:  # before the call below donates the map
            twin = dict(x, pts=_ulp(x["pts"], x["pts"][:, 4] > 0.5))
            jt = self._jax_stage("lio", self.j_frame, (
                jnp_tree(twin["packed"]), jnp_tree(twin["vmap"]),
                jnp_tree(np_tree(pool)), jnp_tree(np_tree(ring)),
                jnp_tree(twin["imu"]), jnp_tree(twin["pts"]), img, fid),
                static)
        j = self._jax_stage("lio", self.j_frame, (
            packed, vmap, pool, ring, imu_pack, pts_pack, img, fid), static)
        out = j.pop("out")
        rec = dict(fid=int(fid), first=first)
        self.frames.append(rec)
        if rec["fid"] in self.keep:
            self.kept[rec["fid"], "lio"] = x
        p = self._port_stage(port_lio, x)
        rec["lio"] = stage_gaps(p, j)
        if twin is not None:
            jt.pop("out")
            rec["lio@jax"] = stage_gaps(jt, j)
            rec["lio@port"] = stage_gaps(self._port_stage(port_lio,
                                                          twin), p)
        return out

    def _jax_stage(self, stage, call, args, static=None):
        """The JAX call (its outputs as numpy, the call's own under
        "out"), with its loops' decisions from JaxTrace (run first: the
        call donates its inputs)."""
        tr = self.jtrace(stage, args, static or {}) if self.trace else None
        out = call(*args, **(static or {}))
        o = (self._jax_lio(out, static["emit_pg"], static["do_map"])
             if stage == "lio" else self._jax_vio(out))
        if tr is not None:
            res, post = tr
            self.jtrace.gap = max(self.jtrace.gap, float(np.abs(
                post[:25] - o["packed"][:25]).max()))
            o.update(res)
        o["out"] = out
        return o

    def _port_stage(self, fn, x):
        with PhotoTrace(self.trace) as tr:
            o = fn(self.port, x)
        o.update(tr.result())
        return o

    @staticmethod
    def _jax_lio(out, emit_pg, do_map):
        o = dict(packed=np.array(out[0]), diag=np.array(out[4]))
        if emit_pg:
            o["pg"] = np.array(out[5])
        if do_map:
            o.update(zip(("keys", "stats", "rec"),
                         (np.array(a) for a in out[1])))
        return o

    # ---- the VIO half

    def _vio(self, packed, pool, ring, vmap, img, pg, fid):
        x = dict(packed=np.array(packed), pool=np_tree(pool),
                 ring=np_tree(ring), vmap=np_tree(vmap), img=np.array(img),
                 pg=np.array(pg), fid=int(fid))
        twin = None
        if self.twins:
            twin = dict(x, packed=_ulp(x["packed"], cols=slice(9, 12)))
            jt = self._jax_stage("vio", self.j_vio, (
                jnp_tree(twin["packed"]), jnp_tree(x["pool"]),
                jnp_tree(x["ring"]), vmap, img, pg, fid))
        j = self._jax_stage("vio", self.j_vio,
                            (packed, pool, ring, vmap, img, pg, fid))
        out = j.pop("out")
        rec = self.frames[-1]
        if rec["fid"] in self.keep:
            self.kept[rec["fid"], "vio"] = x
        p = self._port_stage(port_vio, x)
        rec["vio"] = stage_gaps(p, j)
        rec["vio_n_it"] = p["n_it"]
        if self.trace:
            rec["photo"] = dict(port=p["photo"], jax=j["photo"])
        if twin is not None:
            jt.pop("out")
            pt = self._port_stage(port_vio, twin)
            rec["vio@jax"] = stage_gaps(jt, j)
            rec["vio@port"] = stage_gaps(pt, p)
            if self.trace:
                rec["photo"].update({"port@": pt["photo"],
                                     "jax@": jt["photo"]})
        return out

    @staticmethod
    def _jax_vio(out):
        return dict(packed=np.array(out[0]),
                    pool=[np.array(a) for a in out[1]],
                    ring=[np.array(a) for a in out[2]],
                    vdiag=np.array(out[3]))

    # ---- the deferred insert

    def _map(self, vmap, pg):
        x = dict(vmap=np_tree(vmap), pg=np.array(pg))
        twin = jt = None
        if self.twins:
            twin = dict(x, pg=_ulp(x["pg"], x["pg"][:, 12] > 0.5))
            jt = self._jax_map(self.j_map(jnp_tree(x["vmap"]),
                                          jnp_tree(twin["pg"])))
        out = self.j_map(vmap, pg)
        j = self._jax_map(out)
        p = port_map(self.port, x)
        rec = self.frames[-1]
        rec["map"] = stage_gaps(p, j)
        if twin is not None:
            rec["map@jax"] = stage_gaps(jt, j)
            rec["map@port"] = stage_gaps(port_map(self.port, twin), p)
        return out

    @staticmethod
    def _jax_map(out):
        return dict(zip(("keys", "stats", "rec"), (np.array(a) for a in out)))

def port_lio(port, x):
    """The port's LIO half (LIVOPipeline._frame_step) on the numpy inputs
    x of OneStep._frame: its outputs as numpy."""
    from fast_livo2_tpu_torch.io import convert

    packed, vmap = convert.state_from_numpy(x["packed"], *x["vmap"],
                                            device="cpu")
    packed, vmap, diag, pg = port._frame_step(
        packed, vmap, torch.from_numpy(x["imu"]), torch.from_numpy(x["pts"]),
        first=x["first"], do_map=x["do_map"])
    o = dict(packed=packed.numpy(), diag=diag.numpy())
    if pg is not None:
        o["pg"] = torch.cat([pg.pts_w, pg.normal, pg.var_w6,
                             pg.valid[:, None].to(torch.float32)], -1).numpy()
    if x["do_map"]:
        o.update(keys=vmap.keys.numpy(), stats=vmap.stats.numpy(),
                 rec=vmap.rec.numpy())
    return o


def port_vio(port, x):
    """The port's VIO half (LIVOPipeline._vio_half) on the numpy inputs x
    of OneStep._vio: its outputs as numpy."""
    from fast_livo2_tpu_torch.core.pipeline import ScanPoints
    from fast_livo2_tpu_torch.io import convert

    packed, vmap = convert.state_from_numpy(x["packed"], *x["vmap"],
                                            device="cpu")
    port.pool = convert.pool_from_numpy(*x["pool"], device="cpu")
    port.ring = convert.ring_from_numpy(*x["ring"], device="cpu")
    pg = torch.from_numpy(x["pg"])
    post, vdiag, n_it, pool = port._vio_half(
        packed, torch.from_numpy(x["img"]),
        ScanPoints(pg[:, 0:3], pg[:, 3:6], pg[:, 6:12], pg[:, 12] > 0.5),
        torch.tensor(x["fid"], dtype=torch.int32), vmap)
    return dict(packed=post.numpy(), vdiag=vdiag.numpy(),
                pool=list(convert.pool_to_numpy(pool)),
                ring=list(convert.ring_to_numpy(port.ring)),
                n_it=int(n_it))


def port_map(port, x):
    """The port's deferred insert (LIVOPipeline._insert) on the numpy
    inputs x of OneStep._map: the map as numpy."""
    from fast_livo2_tpu_torch.core.pipeline import ScanPoints

    vmap = port.vmap_state._make(torch.from_numpy(a) for a in x["vmap"])
    pg = torch.from_numpy(x["pg"])
    m = port._insert(vmap, ScanPoints(pg[:, 0:3], pg[:, 3:6], pg[:, 6:12],
                                      pg[:, 12] > 0.5))
    return dict(keys=m.keys.numpy(), stats=m.stats.numpy(),
                rec=m.rec.numpy())


def _tree(a, leaf):
    if isinstance(a, tuple):
        items = [_tree(b, leaf) for b in a]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return leaf(a)


def np_tree(a):
    """A numpy copy of an array, or of a (Named)tuple of arrays."""
    return _tree(a, np.array)


def jnp_tree(a):
    """Fresh JAX arrays of a numpy array, or of a (Named)tuple of them."""
    import jax.numpy as jnp

    return _tree(a, jnp.array)


class PhotoTrace:
    """Records, while active, the port's LIO iterations (calls of
    core/lio's boxplus), the points retrieve selects with their search
    levels and reference patches, and each pyramid level's photometric
    errors (core/vio._iterate_level's normal_equations): result() ->
    {"lio_iters"} or {"retrieved", "warp", "photo"} of what ran. Off
    (`on` False) it records nothing."""

    def __init__(self, on):
        self.on = on
        self.lio_iters, self.retrieved, self.warp, self.photo = (
            0, None, None, [])

    def __enter__(self):
        if not self.on:
            return self
        from fast_livo2_tpu_torch.core import lio, vio

        self.saved = (lio.boxplus, vio.retrieve, vio._iterate_level)
        boxplus, retrieve, iterate = self.saved

        def count_boxplus(*a):
            self.lio_iters += 1
            return boxplus(*a)

        def rec_retrieve(*a, **k):
            submap, pool = retrieve(*a, **k)
            self.retrieved = torch.where(
                submap.valid, submap.search_level.to(torch.int32) + 1,
                0).numpy()
            self.warp = submap.warp_patch.numpy().copy()
            return submap, pool

        def rec_iterate(state_prop, state, G_keep, final_err, P,
                        normal_equations, *a):
            errs = []
            self.photo.append(errs)

            def ne(s):
                out = normal_equations(s)
                errs.append(float(out[2]))
                return out

            return iterate(state_prop, state, G_keep, final_err, P, ne, *a)

        lio.boxplus, vio.retrieve, vio._iterate_level = (
            count_boxplus, rec_retrieve, rec_iterate)
        return self

    def __exit__(self, *exc):
        if self.on:
            from fast_livo2_tpu_torch.core import lio, vio

            lio.boxplus, vio.retrieve, vio._iterate_level = self.saved

    def result(self):
        if not self.on:
            return {}
        if self.photo or self.retrieved is not None:
            return dict(photo=self.photo, retrieved=self.retrieved,
                        warp=self.warp)
        return dict(lio_iters=self.lio_iters)


class JaxTrace:
    """The JAX package's LIO half and VIO half as jit programs of their
    own that also return what their while loops decided: the LIO
    update's iteration count, and each photometric level's error at
    every iteration it ran (the loop body run once more with the accept
    rule forced open, whose carried last_error is then that iteration's
    error), with the points retrieve selected (their search levels and
    reference patches). Built by tracing the
    pipeline's own `_frame_step` / `_vio_half` with `jax.lax.while_loop`
    and `retrieve` replaced; `gap` is the largest gap of such a
    program's posterior to the pipeline's own jit's (0 when the probe
    leaves the arithmetic alone)."""

    MAX_IT = 16

    def __init__(self, jpipe):
        self.jpipe, self.programs, self.gap = jpipe, {}, 0.0

    def __call__(self, stage, args, static):
        """(the decisions, the posterior as numpy) of the stage's program
        on args."""
        key = (stage,) + tuple(sorted(static.items()))
        if key not in self.programs:
            self.programs[key] = self._program(stage, static)
        fn, kinds = self.programs[key]
        out, recs = fn(*args)
        res = {"photo": []} if stage == "vio" else {"lio_iters": 0}
        for kind, r in zip(kinds, recs):
            r = np.asarray(r)
            if kind == "photo":
                res["photo"].append([float(e) for e in r[~np.isnan(r)]])
            elif kind == "lio":
                res["lio_iters"] = int(r)
            else:
                res[kind] = r
        return res, np.array(out[0])

    def _program(self, stage, static):
        import jax
        import jax.numpy as jnp

        from fast_livo2_tpu.core import vio
        from fast_livo2_tpu.core.state import NavState

        fn = self.jpipe._frame_step if stage == "lio" else self.jpipe._vio_half
        kinds, max_it = [], self.MAX_IT

        def traced(*args):
            recs = []
            while_loop, retrieve = jax.lax.while_loop, vio.retrieve

            def rec_while(cond, body, init):
                kind = (None if not isinstance(init, tuple) or len(init) != 7
                        else "photo" if isinstance(init[2], NavState)
                        else "lio" if hasattr(init[5], "normal") else None)
                if kind is None:
                    return while_loop(cond, body, init)
                kinds.append(kind)
                if kind == "lio":
                    out = while_loop(cond, body, init)
                    recs.append(out[0])
                    return out

                def body2(c):
                    inner, errs = c
                    probe = body(inner[:3] + (jnp.float32(3e38),
                                              jnp.asarray(False)) + inner[5:])
                    return body(inner), errs.at[inner[0]].set(probe[3])

                out, errs = while_loop(
                    lambda c: cond(c[0]), body2,
                    (init, jnp.full((max_it,), jnp.nan, jnp.float32)))
                recs.append(errs)
                return out

            def rec_retrieve(*a, **k):
                submap, pool = retrieve(*a, **k)
                kinds.extend(("retrieved", "warp"))
                recs.extend((jnp.where(
                    submap.valid, submap.search_level.astype(jnp.int32) + 1,
                    0), submap.warp_patch))
                return submap, pool

            jax.lax.while_loop, vio.retrieve = rec_while, rec_retrieve
            try:
                out = fn(*args, **static)
            finally:
                jax.lax.while_loop, vio.retrieve = while_loop, retrieve
            return out, recs

        return jax.jit(traced), kinds


def parity_runs(rig, root, keep=()):
    """The rig at the CPU tests' size through the JAX package's LIVO
    pipeline, held one step at a time (OneStep, without twins; the
    inputs of the frame ids `keep` kept) to the port, and the port's
    own runs, split and fused, each reading the same npz directory with
    its own load_sequence(cfg=). Returns dict(jax, step, split, pipe,
    fused, seq_dir, cfg)."""
    import copy

    from fast_livo2_tpu.utils.config import load_config as jax_load_config

    seq_dir, cfg = rig_run(rig, root)
    jtraj, step = jax_run(rig_config(rig, jax_load_config), seq_dir,
                          step=OneStep(cfg, keep=keep))
    split, pipe = port_trajectory(copy.deepcopy(cfg), seq_dir)
    fused, _ = port_trajectory(copy.deepcopy(cfg), seq_dir, fused_frame=True)
    return dict(jax=jtraj, step=step, split=split, pipe=pipe, fused=fused,
                seq_dir=seq_dir, cfg=cfg)


def vio_half_diffs(step):
    """The port's VIO half (LIVOPipeline._vio_half) on the JAX run's own
    inputs at each VIO frame, from the one-step run `step`: {frame id:
    the gaps of its posterior to the JAX package's, a block of
    PACKED_BLOCKS each}."""
    return {f["fid"]: {b: f["vio"][b] for b, _, _ in PACKED_BLOCKS}
            for f in step.frames if "vio" in f}


def vio_half_faults(step, ties):
    """The blocks of the VIO half's posterior above STEP_FLOORS
    (vio_half_diffs), {frame id: [(block, gap, floor)]}; at the VIO ties
    that `ties` lists ({frame id: (stage, pin test)}), above
    TIE_FLOORS."""
    d = vio_half_diffs(step)
    assert len(d) >= 14
    tie = {fid for fid, (stage, _) in ties.items() if stage == "vio"}
    return {fid: f for fid, g in d.items() if (f := above_floors(
        g, TIE_FLOORS if fid in tie else STEP_FLOORS))}


def above_floors(gaps, floors):
    """[(block, gap, floor)] of the gaps above their floors."""
    return [(b, gaps[b], t) for b, t in floors.items()
            if b in gaps and gaps[b] > t]


def one_step_faults(step, ties):
    """Holds a one-step run (OneStep) to the JAX package: every packet
    bit for bit, the map keys bit for bit after every insert (the
    first frame's build and each deferred insert), and at each frame
    every stage's gaps under its floors (STEP_FLOORS: the packed blocks
    of the LIO and VIO halves; MAP_FLOORS: the insert's stats and rec),
    but at the frames that `ties` lists ({frame id: (stage, the pin
    test)}), whose listed stage is a documented tie and is held to
    TIE_FLOORS only. Returns the gaps above a floor, [(frame id, stage,
    block, gap, floor)]."""
    assert step.packets and all(all(p) for p in step.packets), step.packets
    out = []
    for f in step.frames:
        for stage in STAGES:
            g = f.get(stage)
            if g is None:
                continue
            if "keys" in g:
                assert g["keys"] == 0, (f["fid"], stage, g["keys"])
            floors = MAP_FLOORS if stage == "map" else dict(
                STEP_FLOORS, **MAP_FLOORS)
            if ties.get(f["fid"], (None,))[0] == stage:
                floors = TIE_FLOORS
            out += [(f["fid"], stage) + a for a in above_floors(g, floors)]
    return out


def lio_keys_at(step, fid):
    """The voxel keys of the points the LIO half of frame `fid` (its kept
    inputs) downsamples, in each package: the undistorted points over
    filter_size_surf, floored. Returns (leaf, valid, the JAX package's
    undistorted points, the port's) for the points' keys to compare."""
    import jax

    from fast_livo2_tpu.core import imu as jimu
    from fast_livo2_tpu.core import state as jstate

    x, jp, port = step.kept[fid, "lio"], step.jpipe, step.port

    def jax_und(packed, imu, pts):
        st, cov = jstate.unpack_state(packed)
        b = jimu.ImuBatch(gyr=imu[:, 0:3], acc=imu[:, 3:6], dt=imu[:, 6],
                          offs_end=imu[:, 7], valid=imu[:, 8])
        sp, _, poses = jimu.propagate(st, cov, b, jp.noise)
        return jimu.undistort(pts[:, 0:3], pts[:, 3], poses, sp, jp.ext_R,
                              jp.ext_T)

    j = np.asarray(jax.jit(jax_und)(*jnp_tree((x["packed"], x["imu"],
                                               x["pts"]))))
    imu, pts = torch.from_numpy(x["imu"]), torch.from_numpy(x["pts"])
    sp, _, poses = port._stage_propagate(torch.from_numpy(x["packed"]), imu)
    p = port._stage_undistort(sp, poses, imu, pts)[0].numpy()
    return port.cfg.preprocess.filter_size_surf, x["pts"][:, 4] > 0.5, j, p


def assert_downsample_tie(step, fid):
    """A downsample flip at frame `fid` is a tie: the points whose voxel
    differs between the packages lie on a voxel boundary to within the
    float32 resolution of the point (the coordinate that floors apart is
    within 4 ulps of the point's largest |coordinate| of a multiple of
    filter_size_surf, in either package), and there are some. Returns
    their number."""
    leaf, valid, j, p = lio_keys_at(step, fid)
    apart = np.floor(j / leaf) != np.floor(p / leaf)
    moved = valid & np.any(apart, -1)
    assert moved.any()
    for q in (j, p):
        off = np.abs(q / leaf - np.round(q / leaf)) * leaf
        ulp = np.spacing(np.abs(q).max(-1, keepdims=True))
        near = np.all((off <= 4 * ulp) | ~apart, -1)
        assert near[moved].all(), q[moved & ~near]
    return int(moved.sum())


def crossover(step, fid, stage):
    """The one-ulp crossover of frame `fid`'s LIO or VIO half (its kept
    inputs): the position gap of the port to the JAX package, and the
    gaps to the other package's result of each package's one-ulp twin
    (the twins of OneStep) as (port - JAX, port twin - JAX, JAX twin -
    port). A decision that the packages take on either side of a float
    tie shows as a twin that lands on the other package's side."""
    import jax.numpy as jnp

    x, jp = step.kept[fid, stage], step.jpipe
    if stage == "lio":
        twin = dict(x, pts=_ulp(x["pts"], x["pts"][:, 4] > 0.5))

        def jax_post(x):
            img = jnp.zeros(jp.ring.imgs.shape[1:], jnp.uint8)
            return np.array(step.j_frame(
                jnp_tree(x["packed"]), jnp_tree(x["vmap"]),
                jnp_tree(np_tree(jp.pool)), jnp_tree(np_tree(jp.ring)),
                jnp_tree(x["imu"]), jnp_tree(x["pts"]), img, jnp.int32(0),
                first=x["first"], use_vio=False, emit_pg=x["emit_pg"],
                do_map=x["do_map"])[0])

        port = port_lio
    else:
        twin = dict(x, packed=_ulp(x["packed"], cols=slice(9, 12)))

        def jax_post(x):
            return np.array(step.j_vio(*jnp_tree((
                x["packed"], x["pool"], x["ring"], x["vmap"], x["img"],
                x["pg"], np.int32(x["fid"]))))[0])

        port = port_vio
    pos = {k: v[9:12] for k, v in (
        ("jax", jax_post(x)), ("jax1", jax_post(twin)),
        ("port", port(step.port, x)["packed"]),
        ("port1", port(step.port, twin)["packed"]))}

    def gap(a, b):
        return float(np.abs(pos[a] - np.float64(pos[b])).max())

    return gap("port", "jax"), gap("port1", "jax"), gap("jax1", "port")


def assert_crossover(step, fid, stage):
    """Frame `fid`'s stage is a float tie: one package's one-ulp twin
    lands within a tenth of the port-JAX gap of the other package's
    result (`crossover`). Returns the three gaps."""
    gaps = crossover(step, fid, stage)
    assert min(gaps[1:]) < gaps[0] / 10, gaps
    return gaps


def photo_traces(step, fid, pallas_photo=None):
    """Each pyramid level's photometric errors (coarsest level first) of
    frame `fid`'s VIO half on its kept inputs: the port's (K2's plain
    version or the torch-op path as the one-step run had it, or as
    `pallas_photo` says) and the JAX package's (JaxTrace)."""
    import copy

    x = step.kept[fid, "vio"]
    port = step.port
    if pallas_photo is not None:
        cfg = copy.deepcopy(port.cfg)
        cfg.tpu.pallas_photo = pallas_photo
        port = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    with PhotoTrace(True) as tr:
        port_vio(port, x)
    res, _ = JaxTrace(step.jpipe)("vio", (
        jnp_tree(x["packed"]), jnp_tree(x["pool"]), jnp_tree(x["ring"]),
        jnp_tree(x["vmap"]), jnp_tree(x["img"]), jnp_tree(x["pg"]),
        jnp_tree(np.int32(x["fid"]))), {})
    return tr.photo, res["photo"]


def jax_submap(jpipe, x):
    """The submap the JAX package's retrieve builds from frame inputs x
    (OneStep._vio's, as numpy): its fields as numpy."""
    import jax
    import jax.numpy as jnp

    from fast_livo2_tpu.core import state as jstate
    from fast_livo2_tpu.core import vio as jvio

    def build(packed, pool, ring, img, pg, fid):
        img = img.astype(jnp.float32)
        st, _ = jstate.unpack_state(packed)
        pool, ring, _ = jvio.ring_insert(pool, ring, img, fid, jpipe.vio_cfg)
        Rcw, Pcw = jvio.camera_pose(st, jpipe.Rci, jpipe.Pci)
        depth = jvio.rasterize_depth(jpipe.cam, Rcw, Pcw, pg[:, 0:3],
                                     pg[:, 12] > 0.5,
                                     jvio.border_px(jpipe.vio_cfg))
        return jvio.retrieve(pool, ring, img, depth, st, jpipe.cam,
                             jpipe.Rci, jpipe.Pci, jpipe.vio_cfg)[0]

    sub = jax.jit(build)(*jnp_tree((x["packed"], x["pool"], x["ring"],
                                    x["img"], x["pg"], np.int32(x["fid"]))))
    return {f: np.asarray(getattr(sub, f)) for f in sub._fields}


def port_submap(port, x):
    """The port's retrieve on the same inputs (core/vio.vio_step's first
    steps): (state, cov, image, its Submap)."""
    from fast_livo2_tpu_torch.core import vio
    from fast_livo2_tpu_torch.core.state import unpack_state
    from fast_livo2_tpu_torch.io import convert

    st, cov = unpack_state(torch.from_numpy(x["packed"]))
    pool = convert.pool_from_numpy(*x["pool"], device="cpu")
    ring = convert.ring_from_numpy(*x["ring"], device="cpu")
    img = torch.from_numpy(x["img"]).to(torch.float32)
    pg = torch.from_numpy(x["pg"])
    pool, ring, _ = vio.ring_insert(pool, ring, img,
                                    torch.tensor(x["fid"], dtype=torch.int32),
                                    port.vio_cfg)
    Rcw, Pcw = vio.camera_pose(st, port.Rci, port.Pci)
    depth = vio.rasterize_depth(port.cam, Rcw, Pcw, pg[:, 0:3],
                                pg[:, 12] > 0.5, vio.border_px(port.vio_cfg))
    sub = vio.retrieve(pool, ring, img, depth, st, port.cam, port.Rci,
                       port.Pci, port.vio_cfg)[0]
    return st, cov, img, sub


def assert_warp_tie(step, fid):
    """At frame `fid` the VIO half parts from the JAX package's through
    retrieve's reference patches alone, at a patch that is ill-posed in
    either package: the two submaps select the same points at the same
    search levels; the port's photometric update on the JAX package's
    submap starts every pyramid level at the JAX package's error (within
    1e-5); and the patch entry that parts most (by more than one grey
    level) moves by more than one grey level in the port itself when the
    camera position moves by one float32 ulp. Returns that entry's
    values (JAX, port, port one ulp)."""
    from fast_livo2_tpu_torch.core import vio

    x, port = step.kept[fid, "vio"], step.port
    j = jax_submap(step.jpipe, x)
    st, cov, img, sub = port_submap(port, x)
    np.testing.assert_array_equal(j["valid"], sub.valid.numpy())
    np.testing.assert_array_equal(j["search_level"],
                                  sub.search_level.numpy())
    gap = np.abs(j["warp_patch"] - sub.warp_patch.numpy())
    k = np.unravel_index(np.argmax(gap), gap.shape)
    assert gap[k] > 1.0, gap[k]
    twin = dict(x, packed=_ulp(x["packed"], cols=slice(9, 12)))
    moved = port_submap(port, twin)[3].warp_patch.numpy()[k]
    assert abs(moved - sub.warp_patch.numpy()[k]) > 1.0
    jsub = type(sub)(*(torch.from_numpy(np.array(j[f]))
                       for f in sub._fields))
    with PhotoTrace(True) as tr:
        vio.photometric_update(st, cov, jsub, img, port.cam, port.Rci,
                               port.Pci, port.vio_cfg)
    _, jax_photo = photo_traces(step, fid)
    np.testing.assert_allclose([e[0] for e in tr.photo],
                               [e[0] for e in jax_photo], rtol=1e-5)
    return j["warp_patch"][k], sub.warp_patch.numpy()[k], moved


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
    selects: only ntu_viral is above the JAX package's 448-point gate, and
    hilti22's equidistant camera samples as that package's XLA path at
    every M."""
    from fast_livo2_tpu_torch.ops import photo_iteration as tp

    pipe = LIVOPipeline(shrink(load_config(*cs.rig_paths(rig))),
                        slam_mode="livo", device="cpu")
    cfg = pipe.vio_cfg
    assert cfg.grid_n_width * cfg.grid_n_height == M
    assert tp.clip_taps_at(M) == (rig == "ntu_viral")
    assert (pipe.cam.model == "equidistant") == (rig == "hilti22")
    assert tp.clip_taps_at(M, pipe.cam.model) == (rig in ("ntu_viral", "hilti22"))
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


# --------------------------------------- one step at a time (a script)

TABLE_BLOCKS = ("rot", "pos", "vel", "inv_expo", "cov")


def census(step):
    """What a twinned one-step run (`OneStep(twins=True)`) found, as a
    dict: the frames and VIO frames; for each pair (port_vs_jax: the
    port on the JAX run's inputs; jax_1ulp / port_1ulp: each package on
    its one-ulp twin against itself) the frames where a discrete outcome
    moved, by stage and outcome; each such flip with its frame id,
    stage and detail (a photometric flip: pyramid level, iteration,
    (error, last accepted error) of each side); and the one-step floors,
    the largest gap of each packed block over the frames without a
    flip, a stage and pair."""
    pairs = {"port_vs_jax": "", "jax_1ulp": "@jax", "port_1ulp": "@port"}
    out = dict(frames=len(step.frames),
               vio_frames=sum("vio" in f for f in step.frames),
               packets_equal=all(all(p) for p in step.packets),
               flips={}, events=[], floors={})
    for pair, suffix in pairs.items():
        counts, floors = {}, {}
        for f in step.frames:
            for stage in STAGES:
                g = f.get(stage + suffix)
                if g is None:
                    continue
                kinds = flips(g)
                for k in kinds:
                    key = f"{stage}.{k}"
                    counts[key] = counts.get(key, 0) + 1
                if kinds:
                    out["events"].append(dict(
                        pair=pair, fid=f["fid"], stage=stage, flips=kinds,
                        **{k: g[k] for k in ("photo_at", "retrieved_at",
                                             "lio_iters_at") if k in g}))
                    continue
                fl = floors.setdefault(stage, {})
                for b in TABLE_BLOCKS + ("stats", "rec"):
                    if b in g:
                        fl[b] = max(fl.get(b, 0.0), g[b])
        out["flips"][pair] = counts
        out["floors"][pair] = floors
    out["frames_with_flips"] = {
        pair: sorted({e["fid"] for e in out["events"] if e["pair"] == pair})
        for pair in pairs}
    return out


def step_table(step):
    """The one-step run as text: a line a frame and stage with the gaps
    (rot, pos, vel, inv_expo, cov) of the port against the JAX package
    and, with twins, of each package's one-ulp twin against itself,
    then the discrete outcomes that moved in each pair."""
    head = " ".join(f"{b:>8s}" for b in TABLE_BLOCKS)
    lines = [f"{'fid':>4s} {'stage':5s} {'pair':10s} {head}  flips"]
    for f in step.frames:
        for stage in STAGES:
            for suffix, name in (("", "port-JAX"), ("@jax", "JAX 1ulp"),
                                 ("@port", "port 1ulp")):
                g = f.get(stage + suffix)
                if g is None:
                    continue
                vals = " ".join(f"{g[b]:8.1e}" if b in g else f"{'-':>8s}"
                                for b in TABLE_BLOCKS)
                why = {k: g[k] for k in flips(g)}
                for k in ("photo_at", "retrieved_at", "lio_iters_at"):
                    if k in g:
                        why[k] = g[k]
                lines.append(f"{f['fid']:4d} {stage:5s} {name:10s} {vals}  "
                             f"{why or ''}")
    return "\n".join(lines)


def _as_jax_config(cfg):
    """The JAX package's LIVOConfig holding every field of the port's."""
    import copy
    import dataclasses

    from fast_livo2_tpu.utils import config as jconfig

    out = jconfig.LIVOConfig()
    for f in dataclasses.fields(cfg):
        sub, jsub = getattr(cfg, f.name), getattr(out, f.name)
        if not dataclasses.is_dataclass(sub):
            setattr(out, f.name, copy.deepcopy(sub))
            continue
        for g in dataclasses.fields(sub):
            setattr(jsub, g.name, copy.deepcopy(getattr(sub, g.name)))
    return out


def step_run(rig, root, card=False, twins=True, trace=True, k2=None):
    """One JAX LIVO run of the rig held to the port one step at a time
    (OneStep): the rig's recording at this file's size (`rig_run`), or
    with `card` the card's (`_card_recording`, the shipped yamls), or
    for rig "core" bench.py's core sequence at chip_smoke.py's full
    width (6 s, 640 x 512). `k2`: OneStep's. Returns the OneStep."""
    from fast_livo2_tpu.utils.config import load_config as jax_load_config

    if rig == "core":
        cfg = cs.full_width_config()
        seq_dir = os.path.join(root, "base")
        dataset.save_sequence(seq_dir, cs.full_width_sequence())
        jcfg = _as_jax_config(cfg)
    elif card:
        _card_recording(rig, root)
        seq_dir = os.path.join(root, "base")
        cfg = load_config(*cs.rig_paths(rig))
        jcfg = jax_load_config(*cs.rig_paths(rig))
    else:
        seq_dir, cfg = rig_run(rig, root)
        jcfg = rig_config(rig, jax_load_config)
    return jax_run(jcfg, seq_dir, step=OneStep(cfg, twins=twins,
                                               trace=trace, k2=k2))[1]


if __name__ == "__main__":
    # python -m tests.test_torch_rigs ulp RIG DIR [card]
    # python -m tests.test_torch_rigs step RIG [card] [k2]  (RIG: a rig or
    # core; k2: the port's photometric update through K2's plain version)
    import json
    import sys
    import tempfile

    if sys.argv[1] == "run":
        _trajectory(*sys.argv[2:5], sys.argv[6] == "1", sys.argv[5])
    elif sys.argv[1] == "step":
        import tests.conftest  # noqa: F401  (JAX on the CPU)

        torch.set_num_threads(1)
        with tempfile.TemporaryDirectory() as root:
            step = step_run(sys.argv[2], root, card="card" in sys.argv[3:],
                            k2=True if "k2" in sys.argv[3:] else None)
        print(step_table(step))
        print(json.dumps(dict(rig=sys.argv[2], card_size="card" in sys.argv,
                              k2="k2" in sys.argv[3:],
                              trace_gap=step.jtrace.gap, **census(step))))
    else:
        ulp_spread(sys.argv[2], sys.argv[3],
                   len(sys.argv) > 4 and sys.argv[4] == "card")
