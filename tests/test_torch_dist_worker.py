"""One rank of the port's sharded runs (fast_livo2_tpu_torch/parallel/
sharding.py, map_shard.py, and the mesh= arguments of lio_update,
update_map, refine_window, OnlineRefiner and LIVOPipeline), for
tests/test_torch_sharding.py (gloo on the CPU) and tests/test_torch_cuda.py
(gloo with every rank on cuda:0). No test functions here, and no JAX: it
runs only as a process,

    python tests/test_torch_dist_worker.py ADDR WORLD RANK INPUTS.npz OUT_DIR \\
        [cpu|cuda] [CASE ...]

which joins the gloo process group at ADDR (tcp://127.0.0.1:PORT), runs
every case (or the ones named) on INPUTS' arrays and writes its results
to OUT_DIR/rank<RANK>.npz as "<case>/<name>" arrays. `launch` starts the
ranks from a test; the test calls the same case functions with
mesh=None for the single-process results.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAP_LIO = dict(voxel_size=0.5, n_layers=2, capacity_log2=13,
               layer_init_num=(5, 5))  # tests/test_sharding.py
MAP_BA = dict(voxel_size=0.5, n_layers=2, capacity_log2=12,
              layer_init_num=(5, 5))  # tests/test_torch_ba.py
MAP_SHARD = dict(voxel_size=0.5, n_layers=2, capacity_log2=16,
                 layer_init_num=(5, 5))  # tests/test_map_shard.py
MAP_DIST = dict(voxel_size=0.5, n_layers=2, capacity_log2=12,
                layer_init_num=(5, 5))  # tests/dist_worker.py
CAM = dict(cam_model="Pinhole", cam_width=320, cam_height=256, scale=1.0,
           cam_fx=200.0, cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)
MAP_FRAMES = 10  # map updates in a row for the replica check
BA_VARIANTS = ("plain", "links", "photo", "links_photo")


def _port():
    from fast_livo2_tpu_torch.core import lio, voxel_map as vm
    from fast_livo2_tpu_torch.core.state import init_cov, init_state
    from fast_livo2_tpu_torch.io import convert
    from fast_livo2_tpu_torch.parallel import ba, map_shard
    from fast_livo2_tpu_torch.parallel import sharding as shd

    return lio, vm, init_cov, init_state, convert, ba, map_shard, shd


def _np(x):
    return x.detach().cpu().numpy()


def _shard(x, mesh):
    """This rank's rows of x (all of them without a mesh)."""
    from fast_livo2_tpu_torch.parallel import sharding as shd

    return x if mesh is None else shd.shard_points(x, mesh)


def _gather(x, mesh):
    from fast_livo2_tpu_torch.parallel import sharding as shd

    return x if mesh is None else shd.all_gather_rows(x, mesh)


def _lio_map(data, vm, cfg, dev):
    """The LIO scene's map: the JAX package's arrays where the inputs
    carry them, else the port's own insert of the scene, under
    deterministic algorithms on a card so that every rank (and one
    process) starts from the same bits."""
    from fast_livo2_tpu_torch.parallel import sharding as shd

    if "lio/keys" in data:
        return vm.VoxelMap(*(torch.tensor(data[f"lio/{k}"], device=dev)
                             for k in ("keys", "stats", "rec")))
    scene = torch.from_numpy(data["lio/scene"]).to(dev)
    n = scene.shape[0]
    with shd.deterministic(dev):
        return vm.update_map(vm.make_map(cfg, dev), scene,
                             torch.eye(3, device=dev).expand(n, 3, 3) * 1e-4,
                             torch.ones(n, dtype=torch.bool, device=dev), cfg)


def case_lio(data, mesh, dev):
    """tests/test_sharding.py::test_sharded_lio_matches_single_device
    (3 iterations, the points sharded), plus the device loop and the
    plane-information cap (its histogram all_reduced)."""
    lio, vm, init_cov, init_state, _, _, _, _ = _port()
    from fast_livo2_tpu_torch.core.state import pack_state

    cfg = vm.VoxelMapConfig(**MAP_LIO)
    m = _lio_map(data, vm, cfg, dev)
    body = torch.tensor(data["lio/body"], device=dev)
    valid = torch.ones(body.shape[0], dtype=torch.bool, device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    out = {}
    for name, kw in (("split", {}), ("loop", dict(device_loop=True)),
                     ("cap", dict(plane_info_cap=40))):
        res = lio.lio_update(init_state(dev), init_cov(dev), m,
                             _shard(body, mesh), _shard(valid, mesh), eye,
                             zero, cfg, max_iterations=3, mesh=mesh, **kw)
        out.update({f"{name}_packed": _np(pack_state(res.state, res.cov)),
                    f"{name}_cov": _np(res.cov),
                    f"{name}_n_eff": _np(res.n_effective),
                    f"{name}_mean_res": _np(res.mean_residual),
                    f"{name}_pts_w": _np(_gather(res.pts_w, mesh)),
                    f"{name}_dist": _np(_gather(res.match.dist, mesh))})
    return out


def case_map_update(data, mesh, dev):
    """tests/test_sharding.py::test_sharded_map_update_consistent (1024
    points sharded into the LIO scene's map), then MAP_FRAMES updates in a
    row from fresh points: every rank's map after them."""
    _, vm, _, _, _, _, _, _ = _port()
    cfg = vm.VoxelMapConfig(**MAP_LIO)
    m = _lio_map(data, vm, cfg, dev)
    pts = torch.from_numpy(data["map/pts"]).to(dev)
    n = pts.shape[0]
    var = torch.eye(3, device=dev).expand(n, 3, 3) * 1e-4
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    one = vm.update_map(m, _shard(pts, mesh), _shard(var, mesh),
                        _shard(valid, mesh), cfg, mesh=mesh)
    out = {f"one_{k}": _np(v) for k, v in one._asdict().items()}
    frames = torch.from_numpy(data["map/frames"]).to(dev)  # (F, n, 3)
    fvalid = torch.from_numpy(data["map/frames_valid"]).to(dev)
    var6 = torch.from_numpy(data["map/frames_var6"]).to(dev)
    for f in range(frames.shape[0]):
        m = vm.update_map(m, _shard(frames[f], mesh), _shard(var6[f], mesh),
                          _shard(fvalid[f], mesh), cfg, mesh=mesh)
    out.update({f"frames_{k}": _np(v) for k, v in m._asdict().items()})
    return out


def _camera():
    from fast_livo2_tpu_torch.models import camera as tcam
    from fast_livo2_tpu_torch.utils.config import CameraConfig

    return tcam.make_camera(CameraConfig(**CAM))


def case_ba(data, mesh, dev):
    """The three keyframe-sharded cases of tests/test_ba.py (plain, IMU
    links, photometric factors; outer 1 x gn 2) and links + photo, on an
    8-keyframe window: every rank's whole refined window."""
    _, vm, _, _, convert, ba, _, _ = _port()
    cfg = vm.VoxelMapConfig(**MAP_BA)
    win = convert.window_from_numpy(*(data[f"ba/w{i}"] for i in range(4)),
                                    device=dev)
    links = convert.links_from_numpy(*(data[f"ba/l{i}"] for i in range(6)),
                                     device=dev)
    photo = convert.photo_from_numpy(*(data[f"ba/p{i}"] for i in range(6)),
                                     device=dev)
    cam = _camera()
    out = {}
    for name in BA_VARIANTS:
        refined, n_used = ba.refine_window(
            win, cfg, outer_iters=1, gn_iters=2, link_sweeps=2, mesh=mesh,
            imu_links=links if "links" in name else None,
            photo=photo if "photo" in name else None, cam=cam,
            Rci=torch.from_numpy(data["ba/Rci"]).to(dev),
            Pci=torch.zeros(3, device=dev))
        out.update({f"{name}_rot": _np(refined.rot),
                    f"{name}_pos": _np(refined.pos),
                    f"{name}_n_used": _np(n_used)})
    return out


def case_online(data, mesh, dev):
    """tests/test_ba.py::test_online_refiner_async_contract with a mesh:
    submit, a refused second submit, poll(force), drained, the next
    submit (links); the refined poses of the first window."""
    _, vm, _, _, convert, ba, _, _ = _port()
    cfg = vm.VoxelMapConfig(**MAP_BA)
    win = convert.window_from_numpy(*(data[f"ba/w{i}"] for i in range(4)),
                                    device=dev)
    links = convert.links_from_numpy(*(data[f"ba/l{i}"] for i in range(6)),
                                     device=dev)
    r = ba.OnlineRefiner(cfg, outer_iters=1, gn_iters=1, mesh=mesh)
    contract = [r.submit(win, meta="w0"), r.busy, not r.submit(win, meta="w1")]
    meta, rot, pos = r.poll(force=True)
    contract += [meta == "w0", r.poll() is None, not r.busy,
                 r.submit(win, meta="w2", links=links)]
    meta2, rot2, pos2 = r.poll()  # with a mesh every poll waits
    contract += [meta2 == "w2"]
    return {"contract": np.array(contract), "rot": rot, "pos": pos,
            "links_rot": rot2, "links_pos": pos2}


def case_map_shard(data, mesh, dev):
    """tests/test_map_shard.py: the map-sharded refine of a window with
    one corrupted keyframe (outer 2 x gn 3), and every rank's block of a
    persistent 2^18-slot sharded map."""
    _, vm, _, _, convert, ba, map_shard, _ = _port()
    cfg = vm.VoxelMapConfig(**MAP_SHARD)
    win = convert.window_from_numpy(*(data[f"ms/w{i}"] for i in range(4)),
                                    device=dev)
    if mesh is None:
        refined, n_used = ba.refine_window(win, cfg, outer_iters=2,
                                           gn_iters=3)
        return {"rot": _np(refined.rot), "pos": _np(refined.pos),
                "n_used": _np(n_used)}
    refined, n_used = map_shard.refine_window_map_sharded(
        win, cfg, mesh, outer_iters=2, gn_iters=3)
    block = map_shard.sharded_map_arrays(cfg._replace(capacity_log2=18), mesh)
    return {"rot": _np(refined.rot), "pos": _np(refined.pos),
            "n_used": _np(n_used),
            "block_shapes": np.array([b.shape for b in block]),
            "block_device": np.array([b.device.type == mesh.device.type
                                      for b in block])}


def case_dist(data, mesh, dev):
    """tests/dist_worker.py's two computations: the LIO step of
    __graft_entry__._build_lio_example (1024 points, 2 iterations, a 2^12
    map) with the points sharded, and an 8 x 512 window refine (outer 1 x
    gn 2) with the keyframes sharded."""
    lio, vm, init_cov, init_state, convert, ba, _, _ = _port()
    cfg = vm.VoxelMapConfig(**MAP_DIST)
    m = vm.VoxelMap(*(torch.tensor(data[f"dist/{k}"], device=dev)
                      for k in ("keys", "stats", "rec")))
    body = torch.tensor(data["dist/body"], device=dev)
    valid = torch.ones(body.shape[0], dtype=torch.bool, device=dev)
    res = lio.lio_update(init_state(dev), init_cov(dev), m, _shard(body, mesh),
                         _shard(valid, mesh), torch.eye(3, device=dev),
                         torch.zeros(3, device=dev), cfg, max_iterations=2,
                         mesh=mesh)
    win = convert.window_from_numpy(*(data[f"dist/w{i}"] for i in range(4)),
                                    device=dev)
    refined, _ = ba.refine_window(win, cfg, outer_iters=1, gn_iters=2,
                                  mesh=mesh)
    return {"pos": _np(res.state.pos), "cov": _np(res.cov),
            "ba_pos": _np(refined.pos)}


def case_pipeline(data, mesh, dev):
    """A short ONLY_LIO run in every rank's own pipeline with the online
    backend sharded over the mesh (a keyframe every 2 frames, 4-keyframe
    windows every 2, IMU links, feedback, the gate on), then
    refine_trajectory(mesh=) over its keyframes."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import dataset

    seq = dataset.load_sequence(str(data["pipe/seq"]))
    cfg = _pipeline_config()
    pipe = LIVOPipeline(cfg, slam_mode="only_lio", device=dev)
    pipe.enable_online_refine(keyframe_every=2, window=4, stride=2,
                              outer_iters=1, gn_iters=2, mesh=mesh, gate=0.2)
    traj = pipe.process(seq)
    pipe._consume_refine(force=True)
    post = pipe.refine_trajectory(outer_iters=1, gn_iters=2, max_keyframes=8,
                                  mesh=mesh)
    kf = sorted(pipe.refined_keyframes)
    return {"traj_pos": np.array([p for _, _, p in traj]),
            "traj_rot": np.array([R for _, R, _ in traj]),
            "refined_t": np.array(kf),
            "refined_pos": np.array([pipe.refined_keyframes[t][1] for t in kf]),
            "submits": np.array([pipe.refine_submits,
                                 pipe.refine_gate_skips]),
            "post_pos": np.array([p for _, _, p in post]),
            "post_rot": np.array([R for _, R, _ in post])}


def case_collectives(data, mesh, dev):
    """The sharding helpers on rank-dependent values: put_replicated (rank
    0's tree everywhere), agree (rank 0's decision), all_gather_rows of
    float, int and bool rows, all_reduce of booleans (a count)."""
    from fast_livo2_tpu_torch.parallel import sharding as shd
    from fast_livo2_tpu_torch.parallel.ba import Window

    if mesh is None:
        return {}
    r = mesh.rank
    tree = Window(*(torch.full(s, float(r + 1), device=dev)
                    for s in ((2, 3, 3), (2, 3), (2, 5, 3), (2, 5))))
    rep = shd.put_replicated(tree, mesh)
    rows = torch.arange(3, device=dev) + 10 * r
    return {"replicated": np.stack([_np(x).reshape(-1)[:2] for x in rep]),
            "replicated_type": np.array(type(rep).__name__),
            "agree": np.array([shd.agree(r == 0, mesh), shd.agree(r != 0, mesh)]),
            "gather_f": _np(shd.all_gather_rows(rows.float()[:, None] / 4, mesh)),
            "gather_i": _np(shd.all_gather_rows(rows.to(torch.int32), mesh)),
            "gather_b": _np(shd.all_gather_rows(rows % 2 == 0, mesh)),
            "count": _np(shd.all_reduce(torch.tensor(r % 2 == 0, device=dev),
                                        mesh))}


def _pipeline_config():
    from fast_livo2_tpu_torch.utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.preprocess.filter_size_surf = 0.15
    cfg.lio.max_layer = 1
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 2048
    cfg.tpu.hash_capacity_log2 = 14
    return cfg


CASES = {"lio": case_lio, "map_update": case_map_update, "ba": case_ba,
         "online": case_online, "map_shard": case_map_shard,
         "dist": case_dist, "pipeline": case_pipeline,
         "collectives": case_collectives}


WORKER_TIMEOUT_S = 300


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(root, world, inputs, device="cpu", cases=()):
    """Run `world` ranks of this worker on `inputs` (the parent side, for
    the tests); each rank's results as a dict. Every rank is killed if
    any outlives WORKER_TIMEOUT_S (a rank waiting in a collective that
    another never entered), and the test fails."""
    import subprocess

    import pytest

    out = os.path.join(str(root), f"world{world}_{device}")
    os.makedirs(out, exist_ok=True)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), addr, str(world), str(r),
         str(inputs), out, device, *cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append((p.communicate(timeout=WORKER_TIMEOUT_S)[1], p.returncode))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} sharded workers outlived {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (err, rc) in enumerate(errs):
        assert rc == 0, f"rank {r} of {world} failed:\n{err[-4000:]}"
    ranks = []
    for r in range(world):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


def main(argv):
    addr, world, rank, inputs, out_dir = argv[:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    names = argv[6:] or list(CASES)
    world, rank = int(world), int(rank)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from fast_livo2_tpu_torch.parallel import sharding as shd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank, timeout=timedelta(seconds=240))
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        mesh = shd.make_mesh(device=device)
        with np.load(inputs, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
        results = {}
        for name in names:
            for k, v in CASES[name](data, mesh, mesh.device).items():
                results[f"{name}/{k}"] = v
        results["collective_bytes"] = np.array(mesh.collective_bytes)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
