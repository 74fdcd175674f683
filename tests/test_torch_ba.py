"""The port's sliding-window backend (parallel/ba.py) against the JAX
package: `preintegrate`, `refine_window` in its four variants (plain,
IMU links, photometric factors, both) on one small window, and the
OnlineRefiner's contract on the CPU (its card form, one captured CUDA
graph per variant on its own stream, is in tests/test_torch_cuda.py).

The window is tests/test_ba.py's `_make_window` scene at K = 4, N = 800
(three planes, perturbed poses) in a 2^12-slot map, with the planes cut
to 5 x 5 m so that 800 points a keyframe fill their voxels past the
plane fit's 5 points (on 10 x 10 m planes ~15 of 800 points a keyframe
match and the problem is ill-posed); the photometric
variants add tests/test_ba.py's `_photo_window` factors (rendered
keyframe images of a textured wall), made here in numpy and given to
both packages through io/convert.

Tolerance: poses within 1e-4 m and 1e-4 rad of the JAX package's
(tests/test_ba.py's sharded-vs-single bound is 5e-4; here the same
algorithm in another float32 evaluation order, batched over K where the
JAX package vmaps).
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import voxel_map as jvm
from fast_livo2_tpu.models import camera as jcam
from fast_livo2_tpu.parallel import ba as jba
from fast_livo2_tpu.utils.config import CameraConfig as JaxCameraConfig
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.io import convert, synthetic
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.ops import image as img_ops
from fast_livo2_tpu_torch.ops import so3
from fast_livo2_tpu_torch.parallel import ba
from fast_livo2_tpu_torch.parallel.sharding import Mesh
from fast_livo2_tpu_torch.utils.config import CameraConfig
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

MAP = dict(voxel_size=0.5, n_layers=2, capacity_log2=12, layer_init_num=(5, 5))
POS_TOL_M, ROT_TOL = 1e-4, 1e-4
CAM = dict(cam_model="Pinhole", cam_width=320, cam_height=256, scale=1.0,
           cam_fx=200.0, cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)


def _rot(w):
    return so3.exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def _window(K=4, N=800, pose_noise=0.02, seed=0):
    """tests/test_ba.py's _make_window on 5 x 5 m planes, in numpy:
    (window arrays, gt rot, gt pos)."""
    rng = np.random.default_rng(seed)

    def plane_pts(n, normal, d):
        normal = np.asarray(normal, np.float64)
        a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
        b1 = np.cross(normal, a)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(normal, b1)
        uv = rng.uniform(-2.5, 2.5, size=(n, 2))
        return (-d * normal + uv[:, :1] * b1 + uv[:, 1:] * b2
                + rng.normal(size=(n, 3)) * 0.004)

    gt_rot, gt_pos, scans = [], [], []
    for k in range(K):
        R = _rot(rng.normal(size=3) * 0.05)
        p = np.array([0.2 * k, 0.1 * np.sin(k), 0.05 * k])
        world = np.concatenate([plane_pts(N // 3, [0, 0, 1], 1.0),
                                plane_pts(N // 3, [1, 0, 0], -6.0),
                                plane_pts(N - 2 * (N // 3), [0, 1, 0], -6.0)])
        gt_rot.append(R)
        gt_pos.append(p)
        scans.append((world - p) @ R)
    gt_rot, gt_pos = np.array(gt_rot), np.array(gt_pos)
    drot = np.array([_rot(rng.normal(size=3) * pose_noise) for _ in range(K)])
    arrays = (np.einsum("kij,kjl->kil", drot, gt_rot).astype(np.float32),
              (gt_pos + rng.normal(size=(K, 3)) * pose_noise).astype(np.float32),
              np.array(scans, np.float32), np.ones((K, N), bool))
    return arrays, gt_rot, gt_pos


def _links(gt_rot, gt_pos, dt=0.5, seed=1):
    """tests/test_ba.py's _exact_links with 1 cm / 2 mrad of noise, so the
    link residuals are not zero at the truth."""
    rng = np.random.default_rng(seed)
    K = len(gt_rot)
    vel = np.zeros((K, 3))
    for i in range(K - 1):
        vel[i] = (gt_pos[i + 1] - gt_pos[i]) / dt
    dR = np.stack([gt_rot[i].T @ gt_rot[min(i + 1, K - 1)]
                   @ _rot(rng.normal(size=3) * 2e-3) for i in range(K)])
    dp = np.stack([gt_rot[i].T @ (gt_pos[min(i + 1, K - 1)] - gt_pos[i]
                                  - vel[i] * dt) for i in range(K)])
    dp = dp + rng.normal(size=dp.shape) * 0.01
    return (dR, dp, np.full(K, dt), vel, np.array([0.0, 0.0, -9.81]),
            np.arange(K) < K - 1)


def _photo(gt_rot, gt_pos, M=64, ps=8, seed=3):
    """tests/test_ba.py's _photo_window factors for the window's
    keyframes: a textured wall at x = 6 in front of a forward camera,
    factor points on it, targets sampled from each keyframe's image at
    its true pose."""
    rng = np.random.default_rng(seed)
    cam = tcam.make_camera(CameraConfig(**CAM))
    Rci = synthetic.R_CI_FORWARD.astype(np.float32)
    wall = synthetic.Plane(point=np.array([6.0, 0.0, 0.0]),
                           normal=np.array([-1.0, 0, 0]),
                           u_axis=np.array([0, 1.0, 0]),
                           v_axis=np.array([0, 0, 1.0]), tex_seed=11,
                           hf_amp=1.0)
    imgs, pts, tgts, oks = [], [], [], []
    for R, p in zip(gt_rot, gt_pos):
        traj = SimpleNamespace(pose=lambda t, R=R, p=p: (R, p))
        img = synthetic.render_image(traj, [wall], 0.0, cam, R_ci=Rci,
                                     P_ci=np.zeros(3))
        wp = np.stack([np.full(M, 6.0), p[1] + rng.uniform(-1.5, 1.5, M),
                       p[2] + rng.uniform(-0.8, 0.8, M)], -1)
        Rcw = Rci @ R.T
        pf = (wp - p) @ Rcw.T
        px = tcam.world2cam(cam, torch.from_numpy(pf.astype(np.float32)))
        tgt, _, _ = img_ops.sample_patches_with_grad(
            torch.from_numpy(img.astype(np.float32)), px,
            torch.ones(M, dtype=torch.int32), ps)
        imgs.append(img)
        pts.append(wp)
        tgts.append(tgt.numpy())
        oks.append(tcam.in_frame(cam, px, 12).numpy())
    K = len(gt_rot)
    return ((np.array(imgs, np.float32), np.ones(K), np.array(pts),
             np.array(tgts), np.array(oks), np.ones((K, M), np.int32)),
            Rci)


@pytest.fixture(scope="module")
def case():
    """The window, links and photo factors as numpy arrays, and the JAX
    package's refinement of each variant."""
    w, gt_rot, gt_pos = _window()
    links = _links(gt_rot, gt_pos)
    photo, Rci = _photo(gt_rot, gt_pos)
    jcam_ = jcam.make_camera(JaxCameraConfig(**CAM))
    jw = jba.Window(*(jnp.asarray(a) for a in w))
    jl = jba.ImuLinks(*(jnp.asarray(a, jnp.float32) for a in links[:5]),
                      valid=jnp.asarray(links[5]))
    jp = jba.PhotoFactors(*(jnp.asarray(a, jnp.float32) for a in photo[:4]),
                          valid=jnp.asarray(photo[4]),
                          scale=jnp.asarray(photo[5]))
    cfg = jvm.VoxelMapConfig(**MAP)
    out = {}
    for name, use_l, use_p in VARIANTS:
        fn = jax.jit(lambda w, l, p, use_l=use_l, use_p=use_p: jba.refine_window(
            w, cfg, outer_iters=2, gn_iters=2, link_sweeps=2,
            imu_links=l if use_l else None, photo=p if use_p else None,
            cam=jcam_, Rci=jnp.asarray(Rci), Pci=jnp.zeros(3)))
        refined, n_used = fn(jw, jl, jp)
        out[name] = (np.asarray(refined.rot), np.asarray(refined.pos),
                     np.asarray(n_used))
    return w, links, photo, Rci, gt_pos, out


VARIANTS = (("plain", False, False), ("links", True, False),
            ("photo", False, True), ("links_photo", True, True))


def _port_refine(w, links, photo, Rci, use_l, use_p, **kw):
    return ba.refine_window(
        convert.window_from_numpy(*w, device="cpu"), tvm.VoxelMapConfig(**MAP),
        outer_iters=2, gn_iters=2, link_sweeps=2,
        imu_links=convert.links_from_numpy(*links, device="cpu") if use_l else None,
        photo=convert.photo_from_numpy(*photo, device="cpu") if use_p else None,
        cam=tcam.make_camera(CameraConfig(**CAM)), Rci=torch.from_numpy(Rci),
        Pci=torch.zeros(3), **kw)


def test_preintegrate_matches_jax():
    """The same host f64 integrator: equal to the last bit, over an
    interval with samples and tail, and over one without samples."""
    rng = np.random.default_rng(5)
    stamps = np.sort(rng.uniform(0.0, 2.0, 400))
    gyr, acc = rng.normal(size=(400, 3)), rng.normal(size=(400, 3)) + 9.81
    bg, ba_ = rng.normal(size=3) * 1e-2, rng.normal(size=3) * 1e-1
    for t0, t1 in ((0.31, 1.23), (0.5, 0.5 + 1e-6)):
        got = ba.preintegrate(stamps, gyr, acc, bg, ba_, t0, t1)
        want = jba.preintegrate(stamps, gyr, acc, bg, ba_, t0, t1)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_refine_window_matches_jax(case, variant):
    w, links, photo, Rci, gt_pos, out = case
    name, use_l, use_p = variant
    refined, n_used = _port_refine(w, links, photo, Rci, use_l, use_p)
    j_rot, j_pos, j_used = out[name]
    np.testing.assert_allclose(refined.pos.numpy(), j_pos, atol=POS_TOL_M)
    np.testing.assert_allclose(refined.rot.numpy(), j_rot, atol=ROT_TOL)
    np.testing.assert_array_equal(n_used.numpy(), j_used)
    assert n_used.min() > 500
    # the refinement moved the poses (the case tests something)
    assert np.abs(refined.pos.numpy() - w[1]).max() > 10 * POS_TOL_M


def test_online_refiner_async_contract(case):
    """tests/test_ba.py's contract on the CPU: a submit is taken, a second
    one while the first is pending is refused, poll hands back the meta
    and the refined poses (refine_window's, bit for bit), a drained
    refiner polls None and takes the next submit; a mesh is kept."""
    w, links, photo, Rci, _, _ = case
    win = convert.window_from_numpy(*w, device="cpu")
    r = ba.OnlineRefiner(tvm.VoxelMapConfig(**MAP), outer_iters=1, gn_iters=1)
    assert r.submit(win, meta="w0") and r.busy
    assert not r.submit(win, meta="w1")
    meta, rot, pos = r.poll(force=True)
    assert meta == "w0" and rot.shape == (4, 3, 3) and pos.shape == (4, 3)
    want, _ = ba.refine_window(win, tvm.VoxelMapConfig(**MAP), outer_iters=1,
                               gn_iters=1)
    np.testing.assert_array_equal(pos, want.pos.numpy())
    np.testing.assert_array_equal(rot, want.rot.numpy())
    assert r.poll() is None and not r.busy
    assert r.submit(win, meta="w2", links=convert.links_from_numpy(
        *links, device="cpu"))
    assert r.poll()[0] == "w2"  # the CPU refines inside submit
    with pytest.raises(ValueError, match="camera context"):
        r.submit(win, photo=convert.photo_from_numpy(*photo, device="cpu"))
    # keyframe sharding: the refiner keeps its mesh; K must divide over it
    # (the sharded runs themselves: tests/test_torch_sharding.py)
    mesh = Mesh(None, 0, 3, "kf", torch.device("cpu"))
    assert ba.OnlineRefiner(tvm.VoxelMapConfig(**MAP), mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        ba.refine_window(win, tvm.VoxelMapConfig(**MAP), mesh=mesh)
