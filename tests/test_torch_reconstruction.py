"""Port parity: the asset-building modules (``reconstruction/``,
``compat_utils``, ``compat_arguments``, ``utils/colmap2nerf``) of
``pegasus_tpu_torch`` against ``pegasus_tpu``.

The host modules are copies, so each case of the reference's own tests
runs through both packages on the same inputs and the outputs must be
EQUAL: arrays bit for bit, files byte for byte.  The one exception is the
cleaned ply, which the port transforms with torch (to 1e-6).  COLMAP and
pycolmap are absent here: a stub ``colmap`` on PATH
(``testing.COLMAP_STUB``) and a stub pycolmap backend answer as in
``tests/test_recipe_e2e.py`` and
``tests/test_pycolmap_driver.py``.  Last, one environment recipe runs end
to end on the CPU with the port's trainer (64x48, 60 iterations).
"""

import filecmp
import importlib
import json
import os
import shutil
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.gs.ply import load_gs_ply as j_load_ply
from pegasus_tpu.gs.ply import read_ply_vertex_data
from pegasus_tpu.gs.ply import save_gs_ply as j_save_ply
from pegasus_tpu.gs.ply import save_o3d_ply as j_save_o3d
from pegasus_tpu.io import colmap as cio
from pegasus_tpu.testing import build_synthetic_dataset, make_box_cloud, make_colmap_hemisphere

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.testing import install_colmap_stub



def both(module: str):
    """(JAX package's module, port's module) of one relative module path."""
    return (importlib.import_module(f"pegasus_tpu.{module}"),
            importlib.import_module(f"pegasus_tpu_torch.{module}"))


def assert_same_files(a: Path, b: Path, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


# -- reconstruction/ -------------------------------------------------------------------------


def test_alpha_shape_mesh_equal(rng):
    he = np.array([0.05, 0.04, 0.03])
    pts = rng.uniform(-1, 1, size=(3000, 3)) * he
    axis, sign = rng.integers(0, 3, size=1000), rng.choice([-1.0, 1.0], size=1000)
    pts[:1000][np.arange(1000), axis] = sign * he[axis]
    j, t = (m.alpha_shape_mesh(pts, alpha=0.05) for m in both("reconstruction.urdf_gen"))
    assert len(t.faces) > 50
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.faces, j.faces)


def test_urdf_generator_and_cleaning_equal(tmp_path, rng):
    ply = tmp_path / "point_cloud.ply"
    j_save_ply(make_box_cloud(rng, n=2000, half_extents=(0.05, 0.05, 0.07),
                               center=(0.3, 0.2, 0.1)), str(ply))
    gens = []
    for tag, mod in zip("jt", both("reconstruction.urdf_gen")):
        gen = mod.URDFGenerator(ply, object_type="object", mass=0.3)
        gen.generate(tmp_path / f"{tag}.obj", tmp_path / f"{tag}.urdf", alpha=0.08)
        kw = {"device": "cpu"} if tag == "t" else {}
        mod.gs_cleaning(ply, t=gen.center_translation, R=gen.center_rotation,
                        out_path=tmp_path / f"{tag}_clean.ply", **kw)
        gens.append(gen)
    np.testing.assert_array_equal(gens[1].center_translation, gens[0].center_translation)
    assert (tmp_path / "j.obj").read_bytes() == (tmp_path / "t.obj").read_bytes()
    urdf = [(tmp_path / f"{t}.urdf").read_text() for t in "jt"]
    assert urdf[1] == urdf[0].replace("j.obj", "t.obj").replace('name="j"', 'name="t"')
    a, b = (read_ply_vertex_data(str(tmp_path / f"{t}_clean.ply")) for t in "jt")
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=1e-6, err_msg=k)
    assert np.linalg.norm(np.stack([b["x"], b["y"], b["z"]], 1).mean(0)) < 0.03


def test_alignment_equal(tmp_path, rng):
    from scipy.spatial.transform import Rotation

    R0 = Rotation.from_euler("xy", [0.4, -0.25]).as_matrix()
    plane = rng.uniform(-1, 1, size=(400, 3))
    plane[:, 2] = 0.0
    world = plane @ R0.T + np.array([0.1, -0.2, 0.5])
    cams, images = make_colmap_hemisphere(n_images=8, radius=2.0)
    none = np.zeros(0, np.int32)
    points = {i: cio.ColmapPoint3D(i, world[i], np.array([100, 100, 100], np.uint8), 0.1, none,
                                   none) for i in range(len(world))}
    dirs, transforms = [], []
    for tag, mod in zip("jt", both("reconstruction.alignment")):
        sparse = tmp_path / tag / "sparse" / "0"
        sparse.mkdir(parents=True)
        cio.write_cameras_binary(cams, sparse / "cameras.bin")
        cio.write_images_binary(images, sparse / "images.bin")
        cio.write_points3d_binary(points, sparse / "points3D.bin")
        align = mod.ReconstructionAlignment(sparse)
        transforms.append(align.align2plane(plane_size=2.0))
        align.save()
        dirs.append(sparse)
    np.testing.assert_array_equal(transforms[1], transforms[0])
    assert_same_files(*dirs, ("cameras.bin", "images.bin", "points3D.bin"))
    zs = np.array([p.xyz[2] for p in cio.read_points3d_binary(dirs[1] / "points3D.bin").values()])
    assert np.abs(zs).max() < 0.02


def test_image_processors_equal(tmp_path, rng):
    img_dir, mask_dir = tmp_path / "images", tmp_path / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    for name in ("a.png", "b.png", "c.png"):
        Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(img_dir / name)
        m = np.zeros((16, 16), np.uint8)
        m[4:12, 3:13] = 255
        Image.fromarray(m).save(mask_dir / name)
    for cls, kw in (("OrteryImageProcessor", {"hemisphere": "down"}),
                    ("ImageProcessor", {"start_index": 7})):
        written = []
        for tag, mod in zip("jt", both("reconstruction.image_prep")):
            proc = getattr(mod, cls)(img_dir, mask_dir, tmp_path / f"{cls}_{tag}", **kw)
            written.append(proc.process(image_list_name="list.txt"))
        assert written[1] == written[0] and len(written[0]) == 3
        assert_same_files(tmp_path / f"{cls}_j", tmp_path / f"{cls}_t", written[0] + ["list.txt"])


def test_colmap_driver_cases_equal(tmp_path):
    for tag, mod in zip("jt", both("reconstruction.colmap_driver")):
        reco = mod.COLMAPReconstruction(image_path=tmp_path, output_path=tmp_path / f"x_{tag}",
                                        colmap_exe="definitely_not_colmap_xyz")
        with pytest.raises(mod.ColmapNotFoundError):
            reco.run()
    cams, images = make_colmap_hemisphere(n_images=4)
    for tag, mod in zip("jt", both("reconstruction.colmap_driver")):
        sparse = tmp_path / tag / "sparse" / "0"
        sparse.mkdir(parents=True)
        cio.write_cameras_binary(cams, sparse / "cameras.bin")
        cio.write_images_binary(images, sparse / "images.bin")
        mod.COLMAPReconstruction(image_path=tmp_path, output_path=tmp_path / tag) \
            .scale_scene_by_const(2.5)
    assert_same_files(tmp_path / "j" / "sparse" / "0", tmp_path / "t" / "sparse" / "0",
                      ("cameras.bin", "images.bin"))


def test_aruco_ray_intersection_equal():
    rng = np.random.default_rng(0)
    origins = rng.normal(size=(10, 3)) * 2
    dirs = np.array([0.3, -0.2, 0.5]) - origins
    j, t = (m._ls_ray_intersection(origins, dirs) for m in both("reconstruction.aruco_scale"))
    np.testing.assert_array_equal(t, j)


def test_pycolmap_driver_with_stub_equal(tmp_path, monkeypatch):
    import test_pycolmap_driver as ref  # the reference test's stub backend

    for name in ("a", "b"):
        ref._write_images(tmp_path / "sessions" / name)
    calls, layouts = [], []
    for tag, mod in zip("jt", both("reconstruction.pycolmap_driver")):
        stub = ref.StubPycolmap()
        for kw in ({"images": tmp_path / "sessions" / "a"},
                   {"images": tmp_path / "sessions", "matching": "spatial",
                    "camera": mod.DSLR_CAMERA, "dense": False}):
            out = tmp_path / f"out_{tag}_{len(calls)}_{len(stub.calls)}"
            projects = mod.InProcessReconstruction(output=out, backend=stub, **kw).run()
            layouts.append({k: sorted(str(p.relative_to(out)) for p in v["output"].rglob("*"))
                            for k, v in projects.items()})
        calls.append([c[0] for c in stub.calls])
        assert mod.DSLR_CAMERA.to_camera(stub).params == ref.DSLR_CAMERA.to_camera(stub).params
        monkeypatch.setattr(mod, "_import_pycolmap", lambda: None)
        reco = mod.InProcessReconstruction(images=tmp_path / "sessions" / "a", output=tmp_path / "x")
        with pytest.raises(mod.PycolmapNotFoundError):
            reco.run()
    assert calls[1] == calls[0]
    assert layouts[2:] == layouts[:2]


# -- compat_utils, compat_arguments, colmap2nerf ------------------------------------------------


def test_compat_utils_equal(tmp_path):
    j, t = both("compat_utils")
    rng = np.random.default_rng(2)
    q, s = rng.normal(size=(16, 4)), np.exp(rng.normal(size=(16, 3)) * 0.3)
    x = np.array([0.05, 0.3, 0.7, 0.95])
    R, tv, pts = rng.normal(size=(3, 3)), rng.normal(size=3), rng.normal(size=(5, 3))
    pairs = [
        (m.inverse_sigmoid(x), ) + tuple(m.get_expon_lr_func(1e-3, 1e-5, 100, 0.1, 1000)(k)
                                          for k in (-1, 0, 50, 500, 1000))
        + (m.build_rotation(q), m.build_scaling_rotation(s, q),
           m.strip_symmetric(np.einsum("nij,nkj->nik", m.build_scaling_rotation(s, q),
                                       m.build_scaling_rotation(s, q))),
           m.getWorld2View2(R, tv, (0.1, 0.2, 0.3), 2.0), m.getWorld2View(R, tv),
           m.geom_transform_points(pts, m.getWorld2View2(R, tv).T),
           m.focal2fov(500.0, 640), m.fov2focal(0.9, 480))
        for m in (j, t)
    ]
    for a, b in zip(*pairs):
        np.testing.assert_array_equal(b, a)
    pc = t.BasicPointCloud(points=np.zeros((4, 3)), colors=np.ones((4, 3)), normals=np.zeros((4, 3)))
    assert pc._fields == j.BasicPointCloud._fields
    t.mkdir_p(tmp_path / "a" / "b")
    t.mkdir_p(tmp_path / "a" / "b")
    assert (tmp_path / "a" / "b").is_dir()


def test_compat_arguments_equal(tmp_path):
    out = []
    for mod in both("compat_arguments"):
        parser = ArgumentParser()
        groups = (mod.ModelParams(parser), mod.PipelineParams(parser),
                  mod.OptimizationParams(parser))
        args = parser.parse_args(["--iterations", "1234", "--resolution", "2"])
        out.append((vars(args), [vars(g.extract(args)) for g in groups]))
    assert out[1] == out[0]
    assert out[1][0]["iterations"] == 1234


def test_colmap2nerf_equal(tmp_path):
    build_synthetic_dataset(tmp_path)
    sparse = tmp_path / "environment" / "asphalt" / "sparse" / "0"
    res = []
    for tag, mod in zip("jt", both("utils.colmap2nerf")):
        res.append((mod.convert_colmap2nerf(sparse, out_path=tmp_path / f"{tag}.json"),
                    mod.convert_colmap2nerf(sparse, keep_world_scale=True)))
    assert res[1] == res[0] and len(res[1][0]["frames"]) == 16
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()


# -- the recipes ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recipe_tree(tmp_path_factory):
    """A synthetic dataset with a pre-trained environment and object ply
    (and their o3d companions), raw up/down photos with masks for the
    spherical rig, a stub ``colmap`` and the model it installs."""
    root = tmp_path_factory.mktemp("recipes")
    data = root / "data"
    build_synthetic_dataset(data)
    env = data / "environment" / "asphalt"
    obj = data / "object" / "cup_noodles_04"
    rng = np.random.default_rng(4)
    env_ply = env / "gs" / "point_cloud" / "iteration_30000" / "point_cloud.ply"
    # a trained ground is not a perfect plane (a flat one has no 3-D hull)
    flat = j_load_ply(str(env_ply))
    j_save_ply(flat.replace(xyz=flat.xyz.at[:, 2].set(
        rng.normal(scale=0.01, size=flat.num_splats).astype(np.float32))), str(env_ply))
    for ply in (env_ply,
                obj / "fused" / "gs" / "point_cloud" / "iteration_30000" / "point_cloud.ply"):
        j_save_o3d(j_load_ply(str(ply)), str(ply.with_name("point_cloud_o3d.ply")))
    (env / "images").mkdir()
    for hemi, n in (("up", 3), ("down", 2)):
        for sub in ("images", "masks"):
            (obj / hemi / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((24, 32, 3)) * 255).astype(np.uint8)).save(
                obj / hemi / "images" / f"raw_{i:03d}.png")
            Image.fromarray(np.full((24, 32), 255, np.uint8)).save(
                obj / hemi / "masks" / f"raw_{i:03d}.png")

    # the stub mapper's model: the environment's cameras, points from its cloud
    model = root / "stub_model"
    model.mkdir()
    for f in ("cameras.bin", "images.bin"):
        shutil.copyfile(env / "sparse" / "0" / f, model / f)
    xyz = np.asarray(j_load_ply(str(env / "gs" / "point_cloud" / "iteration_30000"
                                    / "point_cloud.ply")).xyz)[::20]
    cio.write_points3d_binary(
        {i + 1: cio.ColmapPoint3D(i + 1, np.asarray(p, np.float64), np.array([128] * 3, np.uint8),
                                  0.1, np.array([1]), np.array([0])) for i, p in enumerate(xyz)},
        model / "points3D.bin")
    bin_dir = root / "bin"
    install_colmap_stub(bin_dir)
    return root, data, bin_dir, model


@pytest.fixture
def stub_colmap(recipe_tree, monkeypatch):
    root, data, bin_dir, model = recipe_tree
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_STUB_MODEL", str(model))
    return recipe_tree


def test_recipes_without_training_equal(stub_colmap, tmp_path):
    """The environment and spherical recipes with ``run_training=False`` on
    a JAX tree and a port tree cut from one dataset: the same stages, the
    same mesh and URDF bytes, the cleaned ply to 1e-6."""
    _, data, _, model = stub_colmap
    trees = {}
    for tag, (asset_cls, recipes) in zip("jt", zip((JAsset, Asset),
                                                   both("reconstruction.recipes"))):
        tree = tmp_path / tag
        shutil.copytree(data, tree)
        kw = {"device": "cpu"} if tag == "t" else {}
        env = asset_cls(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(tree),
                        SCALE=1.0, ALPHA=0.3)
        recipes.environment_reconstruction(env, plane_size=1.0, run_training=False, **kw)
        obj = asset_cls(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=str(tree), SCALE=False,
                        ALPHA=0.4)
        recipes.spherical_object_reconstruction(obj, calibration_reconstruction=str(model),
                                                run_training=False, **kw)
        trees[tag] = (tree, env, obj)
    (jt, jenv, jobj), (tt, tenv, tobj) = trees["j"], trees["t"]
    for ja, ta in ((jenv, tenv), (jobj, tobj)):
        for path in ("urdf_obj_path", "urdf_file_path"):
            assert Path(getattr(ta, path)).read_bytes() == Path(getattr(ja, path)).read_bytes()
    for sub in ("environment/asphalt", "object/cup_noodles_04/fused"):
        stages = json.loads((tt / sub / "stages.json").read_text())
        assert stages == json.loads((jt / sub / "stages.json").read_text()) and stages
        cmp = filecmp.dircmp(jt / sub / "sparse" / "0", tt / sub / "sparse" / "0")
        assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    a, b = (read_ply_vertex_data(o.gaussian_point_cloud_path(30_000)) for o in (jobj, tobj))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=1e-6, err_msg=k)


def test_environment_recipe_end_to_end_on_port(stub_colmap, tmp_path):
    """SfM stub -> const scale -> align2plane -> the port's training (60
    iterations at 64x48 on the CPU) -> alpha-shape URDF."""
    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.gs.ply import load_gs_ply
    from pegasus_tpu_torch.io.mesh import load_mesh
    from pegasus_tpu_torch.io.png import write_png
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.reconstruction.recipes import environment_reconstruction
    from pegasus_tpu_torch.utils.pose import focal2fov

    _, data, _, model = stub_colmap
    root = tmp_path / "data"
    shutil.copytree(data, root)
    base = root / "environment" / "asphalt"
    cloud = load_gs_ply(str(base / "gs" / "point_cloud" / "iteration_30000" / "point_cloud.ply"),
                        device="cpu")
    cams = cio.read_cameras_binary(model / "cameras.bin")
    intr = cams[min(cams)]
    fovx, fovy = focal2fov(intr.params[0], intr.width), focal2fov(intr.params[1], intr.height)
    for im in cio.read_images_binary(model / "images.bin").values():
        cam = Camera.from_colmap(im.qvec, im.tvec, fovx, fovy, 64, 48, device="cpu")
        rgb = rasterize(cloud, cam, max_objects=1).rgb.clamp(0, 1)
        write_png(base / "images" / im.name, (rgb * 255).byte().numpy())

    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                SCALE=1.0, ALPHA=0.3)
    environment_reconstruction(env, train_iterations=60, plane_size=1.0, run_training=True,
                               device="cpu")
    assert json.loads((base / "stages.json").read_text()) == {
        "feature_extractor": True, "matcher": True, "mapper": True}
    out = base / "gs" / "point_cloud" / "iteration_60"
    trained = load_gs_ply(str(out / "point_cloud.ply"), device="cpu")
    assert trained.num_splats > 0 and bool(trained.xyz.isfinite().all())
    assert (out / "point_cloud_o3d.ply").exists()
    assert "asphalt.obj" in Path(env.urdf_file_path).read_text()
    mesh = load_mesh(env.urdf_obj_path)
    assert len(mesh.vertices) > 10 and len(mesh.faces) > 10
    lo, hi = mesh.aabb()
    assert hi[2] - lo[2] < 0.6  # flat-ish environment
