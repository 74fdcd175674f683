"""The port's user tools against the JAX package's scripts, on the CPU.

- mesh: `python -m fast_livo2_tpu_torch.mesh` and scripts/mesh.py's
  main on the same three PCD files (ground-truth-posed scans with
  colours): the port's volume against the script's, weights exact and
  tsdf rtol 1e-6 + 1e-6 (tests/test_torch_outputs.py's tolerance: the
  ray offsets differ from jnp.linspace's in the last bit), and from the
  script's volume the port's PLY byte for byte the script's. The two
  PLYs themselves are not compared: the samples' signed distances are
  multiples of 1/3 whose weighted means sit exactly on 0 in many voxels,
  where a last-bit difference moves a zero crossing (393 against 371
  vertices at this grid);
- export_planes: on a map of a short JAX ONLY_LIO run carried across
  with io/convert, `write_plane_ply` given the JAX map's own records
  writes byte for byte the file of scripts/export_planes.export_plane_ply;
  the port's `export_plane_ply` (its own derive_rec, which agrees with
  JAX's to 1e-6, tests/test_torch_voxel_map.py) writes as many planes,
  its vertices within 2e-4 m (one printed digit of 4 plus the records'
  rounding) and colours within 1 (a uint8 cast of a log-scaled trace),
  and the count equals the occupied _ISPL rows of derive_rec;
- diag_map.census: equal to scripts/diag_map.census on that map;
- fleet_scaling: B = 2 streams on the CPU through its CLI, "placed" not
  measured (no second card).
"""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch import diag_map, export_planes, fleet_scaling, mesh
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.io import convert, export, synthetic

ROOT = Path(__file__).resolve().parent.parent


def _script(name):
    """scripts/<name>.py as a module (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_ply(path):
    """(header lines, vertex rows (n, k) float, face rows) of an ASCII
    PLY."""
    lines = Path(path).read_text().splitlines()
    end = lines.index("end_header")
    header = lines[:end + 1]
    nv = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
    body = lines[end + 1:]
    verts = np.array([[float(x) for x in r.split()] for r in body[:nv]])
    return header, verts.reshape(nv, -1), body[nv:]


def test_mesh_matches_the_jax_script(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from fast_livo2_tpu.io import tsdf as jtsdf
    from fast_livo2_tpu.io.export import read_pcd as jread_pcd
    from fast_livo2_tpu_torch.io import tsdf as ttsdf

    seq = synthetic.make_sequence(duration=0.5, lidar_hz=10.0, imu_hz=200.0,
                                  seed=3, n_lines=12, n_per_line=500,
                                  render=False, fov_deg=360.0)
    rng = np.random.default_rng(0)
    src = tmp_path / "pcds"
    for i in range(3):
        _, pts_w = diag_map._gt_world_points(seq, i)
        export.write_pcd(str(src / f"{i:02d}.pcd"), pts_w.astype(np.float32),
                         colors=rng.integers(0, 256, (len(pts_w), 3)))
    sensor = [float(x) for x in seq.gt[10][2]]  # the sensor near the scans
    args = [str(src), "--voxel", "0.1", "--grid", "64", "--sensor",
            *map(str, sensor)]
    monkeypatch.setattr(sys, "argv", ["mesh.py", *args, "-o",
                                      str(tmp_path / "j.ply")])
    _script("mesh").main()
    nv, nf = mesh.main([*args, "-o", str(tmp_path / "t.ply"),
                        "--device", "cpu"])
    assert nv > 100 and nf > 100
    # the script's volume, step by step with the JAX functions it calls
    files = mesh.pcd_files(str(src))
    jclouds = [jread_pcd(f) for f in files]
    all_pts = np.concatenate([c[0] for c in jclouds])
    side = max(float((all_pts.max(0) - all_pts.min(0)).max()) * 1.1, 0.1 * 64)
    jvol = jtsdf.make_volume(0.5 * (all_pts.min(0) + all_pts.max(0)), side,
                             grid=64)
    for pts, _, _ in jclouds:
        jvol = jtsdf.integrate(jvol, jnp.asarray(pts), jnp.ones(len(pts), bool),
                               jnp.asarray(sensor, jnp.float32))
    clouds = [export.read_pcd(f) for f in files]
    tvol = mesh.integrate_clouds(clouds, 0.1, 64, sensor, "cpu")
    np.testing.assert_array_equal(tvol.weight.numpy(), np.asarray(jvol.weight))
    np.testing.assert_allclose(tvol.tsdf.numpy(), np.asarray(jvol.tsdf),
                               rtol=1e-6, atol=1e-6)
    # from the script's volume, the port's mesh and PLY: the same bytes
    carried = ttsdf.TSDFVolume(
        tsdf=torch.from_numpy(np.array(jvol.tsdf)),
        weight=torch.from_numpy(np.array(jvol.weight)),
        origin=torch.from_numpy(np.array(jvol.origin)), voxel=jvol.voxel,
        trunc=jvol.trunc)
    ttsdf.write_ply_mesh(str(tmp_path / "c.ply"),
                         *mesh.mesh_volume(carried, clouds))
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.fixture(scope="module")
def jax_map():
    """A map of the JAX package's ONLY_LIO run (scripts/export_planes.py's
    configuration, 1 s of its 3 s sequence), as numpy, with its map
    config."""
    seq = synthetic.make_sequence(duration=1.0, lidar_hz=10.0, imu_hz=200.0,
                                  seed=0, n_lines=12, n_per_line=500,
                                  render=False, fov_deg=360.0)
    cfg = JaxConfig()
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.lio.max_layer = 1
    pipe = JaxPipeline(cfg, slam_mode="only_lio")
    pipe.process(seq)
    return pipe


def _port_map(jpipe):
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.lio.max_layer = 1
    map_cfg = LIVOPipeline(cfg, slam_mode="only_lio", device="cpu").map_cfg
    _, vmap = convert.state_from_numpy(
        np.asarray(jpipe.packed), *(np.asarray(a) for a in jpipe.vmap_state),
        device="cpu")
    return vmap, map_cfg


def test_export_planes_matches_the_jax_script(jax_map, tmp_path):
    from fast_livo2_tpu.core import voxel_map as jvm

    jplanes = _script("export_planes")
    jn = jplanes.export_plane_ply(jax_map.vmap_state, jax_map.map_cfg,
                                  str(tmp_path / "j.ply"))
    assert jn > 50
    # the writer, from the JAX map's own records: the same bytes
    keys = np.asarray(jax_map.vmap_state.keys)
    jrec = np.asarray(jvm.derive_rec(jax_map.vmap_state, jax_map.map_cfg))
    assert export_planes.write_plane_ply(keys, jrec,
                                         str(tmp_path / "w.ply")) == jn
    assert (tmp_path / "w.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    # the port end to end on the carried map
    vmap, map_cfg = _port_map(jax_map)
    tn = export_planes.export_plane_ply(vmap, map_cfg, str(tmp_path / "t.ply"))
    rec = tvm.derive_rec(vmap, map_cfg).numpy()
    occupied = (vmap.keys.numpy() != tvm.EMPTY).all(-1)
    assert tn == jn == int(((rec[..., tvm._ISPL] > 0.5) & occupied).sum())
    jh, jv, jf = _read_ply(tmp_path / "j.ply")
    th, tv, tf = _read_ply(tmp_path / "t.ply")
    assert th == jh and tf == jf
    np.testing.assert_allclose(tv[:, :3], jv[:, :3], rtol=0, atol=2e-4)
    assert np.abs(tv[:, 3:] - jv[:, 3:]).max() <= 1


def test_diag_map_census_matches_the_jax_script(jax_map):
    jcensus = _script("diag_map").census(jax_map)
    vmap, map_cfg = _port_map(jax_map)
    census = diag_map.census(SimpleNamespace(vmap_state=vmap, map_cfg=map_cfg))
    assert census == jcensus
    assert sum(r["solid"] for r in census) > 50


def test_fleet_scaling_two_streams_on_the_cpu(capsys):
    rows = fleet_scaling.main(["2", "--device", "cpu"])
    (B, fps, placed), = rows
    assert B == 2 and fps > 0 and placed is None
    out = capsys.readouterr().out
    assert "placed: not measured" in out and "| 2 |" in out
