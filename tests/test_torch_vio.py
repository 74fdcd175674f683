"""The port's VIO frame (core/vio.py) and LIVO pipeline against the JAX
package.

One JAX LIVO run over a 1.6 s rendered sequence (tests/test_pipeline_
livo.py's small camera and config) gives both the reference trajectory
and, at one mid-sequence frame, the exact inputs of its VIO half: the
state after the LIO update, the visual pool, frame ring, voxel map,
image and scan. The function tests start both packages from those
inputs, carried across as numpy arrays (io/convert), and feed each
stage the JAX output of the stage before it.

Tolerances, each with its reason:
- ring insert, retrieval's valid / point_idx / search_level, and the
  integer columns of maintained pool rows: exact (integer logic on the
  same floats);
- the depth raster and other float outputs: 1e-5 relative (float32 in
  another evaluation order), DN-scale patches 1e-3 absolute; warped
  reference patches 0.25 DN (see the retrieval test);
- photometric_update: state 1e-5, covariance rtol 1e-3 (an iterated
  filter over 3 pyramid levels);
- the pipeline: 8e-3 m / 4e-3 (tests/test_golden_trace.py's tolerances;
  the photometric error feeds back through up to 15 iterations a frame).
  JAX on the CPU always takes its XLA photometric path, so both sides
  run with tpu.pallas_photo = False; the port with it True (K2's plain
  version) agrees with itself False to 1e-3 m (test_pallas_photo.py:140).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import state as jstate
from fast_livo2_tpu.core import vio as jvio
from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import CameraConfig
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.core import vio as tvio
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import convert, synthetic
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.utils.config import LIVOConfig

CAPTURE_FRAME = 7  # a frame with ~150 tracked points and a full pool
POS_TOL_M, ROT_TOL = 8e-3, 4e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small ops a frame: with the suite's parallel workers
    each holding a full intra-op thread pool, the pools oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def livo_config(cls, pallas_photo=False):
    """tests/test_pipeline_livo.py's livo_config, for either package."""
    cfg = cls()
    cfg.camera = CameraConfig(cam_model="Pinhole", cam_width=320,
                              cam_height=256, scale=1.0, cam_fx=200.0,
                              cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.extrin_calib.Pcl = [0.0, 0.0, 0.0]
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.tpu.vis_point_capacity = 8192
    cfg.tpu.frame_ring = 32
    cfg.tpu.pallas_photo = pallas_photo
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    cfg.vio.patch_pyrimid_level = 3
    return cfg


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pipeline over the sequence, with its VIO-half inputs at
    CAPTURE_FRAME copied out (before the call donates them)."""
    cam = tcam.make_camera(livo_config(LIVOConfig).camera)
    seq = synthetic.make_sequence(
        duration=1.6, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=0, n_lines=12, n_per_line=500, render=True, fov_deg=360.0)
    pipe = JaxPipeline(livo_config(JaxConfig), slam_mode="livo")
    captured = {}
    vio_half = pipe._vio_half_jit

    def spy(packed, pool, ring, vmap_state, img, pg_pack, fid):
        if int(fid) == CAPTURE_FRAME:
            captured.update(
                packed=np.array(packed), pool=[np.array(a) for a in pool],
                ring=[np.array(a) for a in ring],
                vmap=[np.array(a) for a in vmap_state], img=np.array(img),
                pg=np.array(pg_pack), frame_id=int(fid))
        return vio_half(packed, pool, ring, vmap_state, img, pg_pack, fid)

    pipe._vio_half_jit = spy
    traj = pipe.process(seq)
    assert captured, "the capture frame never ran"
    return seq, traj, pipe, captured


def _inputs(cap):
    """The captured VIO-half inputs, for each package."""
    jp = JaxPipeline(livo_config(JaxConfig), slam_mode="livo")  # cam, Rci, ...
    jst, jcov = jstate.unpack_state(jnp.asarray(cap["packed"]))
    pg = cap["pg"]
    J = dict(state=jst, cov=jcov,
             pool=jvio.VisualPool(*(jnp.asarray(a) for a in cap["pool"])),
             ring=jvio.FrameRing(*(jnp.asarray(a) for a in cap["ring"])),
             vmap=type(jp.vmap_state)(*(jnp.asarray(a) for a in cap["vmap"])),
             img=jnp.asarray(cap["img"].astype(np.float32)),
             pg_w=jnp.asarray(pg[:, 0:3]), pg_n=jnp.asarray(pg[:, 3:6]),
             pg_v6=jnp.asarray(pg[:, 6:12]), pg_ok=jnp.asarray(pg[:, 12] > 0.5),
             cam=jp.cam, cfg=jp.vio_cfg, map_cfg=jp.map_cfg, Rci=jp.Rci,
             Pci=jp.Pci)
    tp = LIVOPipeline(livo_config(LIVOConfig), slam_mode="livo", device="cpu")
    tpacked, tmap = convert.state_from_numpy(cap["packed"], *cap["vmap"],
                                             device="cpu")
    tst, tcov = tstate.unpack_state(tpacked)
    T = dict(state=tst, cov=tcov,
             pool=convert.pool_from_numpy(*cap["pool"], device="cpu"),
             ring=convert.ring_from_numpy(*cap["ring"], device="cpu"),
             vmap=tmap, img=torch.from_numpy(cap["img"].astype(np.float32)),
             pg_w=torch.from_numpy(pg[:, 0:3].copy()),
             pg_n=torch.from_numpy(pg[:, 3:6].copy()),
             pg_v6=torch.from_numpy(pg[:, 6:12].copy()),
             pg_ok=torch.from_numpy(pg[:, 12] > 0.5), cam=tp.cam,
             cfg=tp.vio_cfg, map_cfg=tp.map_cfg, Rci=tp.Rci, Pci=tp.Pci)
    assert tuple(T["cfg"]) == tuple(J["cfg"])
    return J, T


@pytest.fixture(scope="module")
def jax_frame(jax_run):
    """The JAX VIO frame at CAPTURE_FRAME, stage by stage (vio_step's
    order), as one jitted program. Returns (the port's inputs T, the frame
    id, the JAX outputs of every stage as numpy, the JAX inputs)."""
    cap = jax_run[3]
    J, T = _inputs(cap)
    cam, cfg, map_cfg = J["cam"], J["cfg"], J["map_cfg"]

    @jax.jit
    def frame(state, cov, pool, ring, vmap, img, pg_w, pg_n, pg_v6, pg_ok,
              Rci, Pci, fid):
        pool, ring, slot = jvio.ring_insert(pool, ring, img, fid, cfg)
        Rcw, Pcw = jvio.camera_pose(state, Rci, Pci)
        depth = jvio.rasterize_depth(cam, Rcw, Pcw, pg_w, pg_ok,
                                     jvio.border_px(cfg))
        sub, _ = jvio.retrieve(pool, ring, img, depth, state, cam, Rci, Pci,
                               cfg)
        post = jvio.photometric_update(state, cov, sub, img, cam, Rci, Pci,
                                       cfg)
        maintained = jvio.generate_and_maintain(
            pool, vmap, map_cfg, sub, img, pg_w, pg_n, pg_v6, pg_ok, post[0],
            cam, Rci, Pci, fid, slot, cfg)
        return pool, ring, slot, depth, sub, post, maintained

    fid = cap["frame_id"]
    out = frame(J["state"], J["cov"], J["pool"], J["ring"], J["vmap"],
                J["img"], J["pg_w"], J["pg_n"], J["pg_v6"], J["pg_ok"],
                J["Rci"], J["Pci"], jnp.int32(fid))
    names = ("pool", "ring", "slot", "depth", "sub", "post", "maintained")
    return T, fid, dict(zip(names, jax.tree.map(np.asarray, out))), J


def _submap_to_torch(jsub):
    return tvio.Submap(*(torch.from_numpy(np.array(a)) for a in jsub))


def test_ring_insert_depth_and_retrieve_match_jax(jax_frame):
    T, fid, J, _ = jax_frame
    tpool, tring, tslot = tvio.ring_insert(T["pool"], T["ring"], T["img"],
                                           fid, T["cfg"])
    assert tslot == int(J["slot"])
    for a, b in zip(convert.pool_to_numpy(tpool), J["pool"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(convert.ring_to_numpy(tring), J["ring"]):
        np.testing.assert_array_equal(a, b)
    tR, tP = tvio.camera_pose(T["state"], T["Rci"], T["Pci"])
    tdepth = tvio.rasterize_depth(T["cam"], tR, tP, T["pg_w"], T["pg_ok"],
                                  tvio.border_px(T["cfg"]))
    np.testing.assert_allclose(tdepth.numpy(), J["depth"], rtol=1e-5)
    # retrieval from the same depth raster
    tsub, _ = tvio.retrieve(tpool, tring, T["img"],
                            torch.from_numpy(np.array(J["depth"])), T["state"], T["cam"],
                            T["Rci"], T["Pci"], T["cfg"])
    jsub = J["sub"]
    valid = jsub.valid
    assert valid.sum() > 50
    np.testing.assert_array_equal(tsub.valid.numpy(), valid)
    np.testing.assert_array_equal(tsub.point_idx.numpy(), jsub.point_idx)
    np.testing.assert_array_equal(tsub.search_level.numpy(), jsub.search_level)
    for name in ("pos", "ref_expo", "ref_meta", "point_rows", "obs_rows",
                 "patch_rows"):
        np.testing.assert_allclose(getattr(tsub, name).numpy(),
                                   getattr(jsub, name), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # The warp's affine matrix is a difference of projections 4 px apart
    # (float32 cancellation, ~1e-5 relative, and XLA fuses the chain
    # differently), and its samples lie up to 64 px from the patch centre,
    # so the warped samples of tracked points agree to 0.25 DN (0.1 % of
    # the range). Their squared errors over 64 samples then differ by at
    # most 2 |e| |d| + |d|^2 with |d| <= 8 * 0.25 (Cauchy-Schwarz).
    np.testing.assert_allclose(tsub.warp_patch.numpy()[valid],
                               jsub.warp_patch[valid], atol=0.25)
    j_err = jsub.propa_error[valid]
    assert np.all(np.abs(tsub.propa_error.numpy()[valid] - j_err)
                  <= 4.0 * np.sqrt(j_err) + 4.0)


@pytest.mark.parametrize("variant", [
    dict(normal_en=False), dict(ncc_en=True, ncc_thre=0.9)],
    ids=["closest_view", "ncc_gate"])
def test_retrieve_variants_match_jax(jax_frame, variant):
    """Retrieval's other reference selection (normal_en = False: the
    closest view and a fronto-parallel warp) and its NCC gate, from the
    same ring-inserted pool and depth raster."""
    T, _, J, Jin = jax_frame
    jcfg = Jin["cfg"]._replace(**variant)
    cam = Jin["cam"]
    jsub, _ = jax.jit(lambda pool, ring, img, depth, state, Rci, Pci: jvio.retrieve(
        pool, ring, img, depth, state, cam, Rci, Pci, jcfg))(
        jvio.VisualPool(*(jnp.asarray(a) for a in J["pool"])),
        jvio.FrameRing(*(jnp.asarray(a) for a in J["ring"])), Jin["img"],
        jnp.asarray(J["depth"]), Jin["state"], Jin["Rci"], Jin["Pci"])
    tsub, _ = tvio.retrieve(
        convert.pool_from_numpy(*J["pool"], device="cpu"),
        convert.ring_from_numpy(*J["ring"], device="cpu"), T["img"],
        torch.from_numpy(np.array(J["depth"])), T["state"], T["cam"],
        T["Rci"], T["Pci"], T["cfg"]._replace(**variant))
    valid = np.asarray(jsub.valid)
    assert valid.sum() > 20
    # the variant changes the submap: fewer points, or other warps
    assert (valid.sum() < J["sub"].valid.sum()
            or not np.allclose(np.asarray(jsub.warp_patch)[valid],
                               J["sub"].warp_patch[valid], atol=1.0))
    np.testing.assert_array_equal(tsub.valid.numpy(), valid)
    np.testing.assert_array_equal(tsub.point_idx.numpy(), np.asarray(jsub.point_idx))
    np.testing.assert_array_equal(tsub.search_level.numpy(),
                                  np.asarray(jsub.search_level))
    np.testing.assert_allclose(tsub.ref_meta.numpy(), np.asarray(jsub.ref_meta),
                               rtol=1e-5, atol=1e-6)
    # the warp tolerance of the test above
    np.testing.assert_allclose(tsub.warp_patch.numpy()[valid],
                               np.asarray(jsub.warp_patch)[valid], atol=0.25)


@pytest.mark.parametrize("true_pyramid", [False, True],
                         ids=["raw_strided", "true_pyramid"])
def test_photometric_update_matches_jax(jax_frame, true_pyramid):
    """From the same submap (JAX's), state and image: the torch-op path,
    sampling the raw strided level-0 image or the box-average stack."""
    T, _, J, Jin = jax_frame
    cfg = T["cfg"]._replace(true_pyramid=true_pyramid)
    ts, tc, te, iters = tvio.photometric_update(
        T["state"], T["cov"], _submap_to_torch(J["sub"]), T["img"], T["cam"],
        T["Rci"], T["Pci"], cfg)
    if true_pyramid:
        jcfg, cam = Jin["cfg"]._replace(true_pyramid=True), Jin["cam"]
        jsub = jvio.Submap(*(jnp.asarray(a) for a in J["sub"]))
        js, jc, je = jax.tree.map(np.asarray, jax.jit(
            lambda st, cv, img, Rci, Pci: jvio.photometric_update(
                st, cv, jsub, img, cam, Rci, Pci, jcfg))(
            Jin["state"], Jin["cov"], Jin["img"], Jin["Rci"], Jin["Pci"]))
    else:
        js, jc, je = J["post"]
    assert 3 <= iters <= 3 * T["cfg"].max_iterations
    for name, a, b in zip(tstate.NavState._fields, ts, js):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)


_INT_POINT_COLS = [tvio._P_VALID, tvio._P_CONV, tvio._P_HASREF, tvio._P_REF]
_INT_OBS_COLS = [tvio._O_VALID, tvio._O_SLOT, tvio._O_FID]


def test_generate_and_maintain_matches_jax(jax_frame):
    """From the same ring-inserted pool, submap, posterior state and scan:
    the pool after new-point generation, the observation update and the
    reference refinement."""
    T, fid, J, _ = jax_frame
    tpool = convert.pool_from_numpy(*J["pool"], device="cpu")
    ts = tstate.NavState(*(torch.from_numpy(np.array(a)) for a in J["post"][0]))
    tpool, tadd, tn = tvio.generate_and_maintain(
        tpool, T["vmap"], T["map_cfg"], _submap_to_torch(J["sub"]), T["img"],
        T["pg_w"], T["pg_n"], T["pg_v6"], T["pg_ok"], ts, T["cam"], T["Rci"],
        T["Pci"], fid, int(J["slot"]), T["cfg"])
    jpool, jadd, jn = J["maintained"]
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tadd.numpy(), jadd)
    t_point, t_obs, t_patch, t_alloc = convert.pool_to_numpy(tpool)
    j_point, j_obs, j_patch, j_alloc = jpool
    assert float(t_alloc) == float(j_alloc)
    np.testing.assert_array_equal(t_point[:, _INT_POINT_COLS],
                                  j_point[:, _INT_POINT_COLS])
    np.testing.assert_array_equal(t_obs[..., _INT_OBS_COLS], j_obs[..., _INT_OBS_COLS])
    np.testing.assert_allclose(t_point, j_point, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_obs, j_obs, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t_patch, j_patch, rtol=1e-5, atol=1e-3)


def _positions(traj):
    return np.array([p for _, _, p in traj])


def test_livo_pipeline_matches_jax(jax_run):
    seq, jtraj, jpipe, _ = jax_run
    runs = {}
    for fused in (False, True):
        pipe = LIVOPipeline(livo_config(LIVOConfig, pallas_photo=fused),
                            slam_mode="livo", device="cpu")
        runs[fused] = (pipe.process(seq), pipe)
    traj, pipe = runs[False]
    assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
    assert len(traj) >= 12
    np.testing.assert_allclose(_positions(traj), _positions(jtraj), atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in jtraj]), atol=ROT_TOL)
    ate = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert ate < 0.06, f"LIVO ATE RMSE {ate:.3f} m"
    tracked = [r["n_tracked"] for r in pipe.log.rows[3:]]
    assert np.mean(tracked) > 20, f"VIO tracked too few points: {tracked}"
    assert [r["n_tracked"] for r in pipe.log.rows[:3]] == [
        r["n_tracked"] for r in jpipe.log.rows[:3]]
    # the fused path (K2's plain version on the CPU) against the torch-op path
    traj_f, pipe_f = runs[True]
    dp = np.linalg.norm(_positions(traj_f) - _positions(traj), axis=-1)
    assert dp.max() < 1e-3, dp
    assert pipe_f.photo_iterations > 0


@pytest.mark.parametrize("variant", [
    dict(), dict(true_pyramid=True), dict(pallas_photo=True)],
    ids=["raw_strided", "true_pyramid", "fused_kernel_plain"])
def test_photometric_device_loop_equals_early_exit(jax_frame, variant):
    """The device-loop form (all levels x max_iterations iterations,
    each carried value masked, no host read; the fused and staged
    frames) gives the early-exit form's state, covariance and error bit
    for bit from the same submap, and counts the same iterations."""
    T, _, J, _ = jax_frame
    cfg = T["cfg"]._replace(**variant)
    args = (T["state"], T["cov"], _submap_to_torch(J["sub"]), T["img"],
            T["cam"], T["Rci"], T["Pci"], cfg)
    es, ec, ee, e_it = tvio.photometric_update(*args)
    ls, lc, le, l_it = tvio.photometric_update(*args, device_loop=True)
    for name, a, b in zip(tstate.NavState._fields, es, ls):
        assert torch.equal(a, b), name
    assert torch.equal(ec, lc) and torch.equal(ee, le)
    assert isinstance(l_it, torch.Tensor) and int(l_it) == e_it
    if not cfg.true_pyramid:  # (there every level runs all its iterations)
        # levels stopped early: the masked iterations were exercised
        assert e_it < cfg.pyramid_levels * cfg.max_iterations
