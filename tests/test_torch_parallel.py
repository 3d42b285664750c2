"""Port parity, scale-out rendering: ``parallel/mesh.py``, ``parallel/sharded_render.py``,
``ops/validate.py`` and ``generate_scene_variants(mesh=)``.

The scene of ``tests/test_parallel.py`` (a 500-splat plane and two boxes,
48x40, K = 4) is made by the JAX package from a numpy seed and carried
across as numpy.  The JAX side renders it splat-sharded on its 8-device
virtual CPU mesh (golden backend); the port renders it on CPU lanes
(``make_mesh(devices=["cpu"] * n)``) with each of its backends.  Tolerance:
every ``RenderOutputs`` field max |diff| <= 1e-5 against the JAX render and
against the port's unsharded ``rasterize`` (same float32 terms, grouped
differently); two renders on one mesh are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.cloud import merge as j_merge
from pegasus_tpu.ops.validate import psnr_db as j_psnr_db
from pegasus_tpu.parallel.mesh import make_mesh as j_make_mesh
from pegasus_tpu.parallel.sharded_render import rasterize_splat_sharded as j_sharded
from pegasus_tpu.parallel.sharded_render import rasterize_splat_sharded_batch as j_sharded_batch
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import merge
from pegasus_tpu_torch.interop import CLOUD_FIELDS, cloud_from_numpy
from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import num_channels, rasterize
from pegasus_tpu_torch.ops.validate import compare_backends, psnr_db
from pegasus_tpu_torch.parallel.mesh import (Lane, lane_slices, make_mesh, map_lanes, replicate,
                                             split_batch)
from pegasus_tpu_torch.parallel.scene_batch import generate_scene_variants
from pegasus_tpu_torch.parallel.sharded_render import (_local_render, combine_in_order,
                                                       identity_payload, rasterize_splat_sharded,
                                                       rasterize_splat_sharded_batch)
from pegasus_tpu_torch.physics import rigid_body as rb
from pegasus_tpu_torch.scene.composition import SceneTemplate
from pegasus_tpu_torch.testing import make_box_cloud, make_plane_cloud

torch.set_num_threads(1)

BG = (0.2, 0.1, 0.3)
K = 4
VIEW = dict(eye=(0.5, 0.4, 0.6), target=(0, 0, 0.05), up=(0, 0, 1), fovx=np.deg2rad(55),
            fovy=np.deg2rad(45), width=48, height=40)
FIELDS = ("rgb", "depth", "alpha", "seg_weights", "vis_weights", "amodal")
ATOL = 1e-5


def as_torch(cloud):
    return cloud_from_numpy({f: np.asarray(getattr(cloud, f)) for f in CLOUD_FIELDS}, device="cpu")


def cpu_mesh(n, axis="splat"):
    return make_mesh((n,), (axis,), ["cpu"] * n)


def max_diff(a, b):
    return max(float(np.abs(np.asarray(getattr(a, f), np.float64)
                            - np.asarray(getattr(b, f), np.float64)).max()) for f in FIELDS)


@pytest.fixture(scope="module")
def scene():
    """tests/test_parallel.py's scene in both packages, and the JAX package's
    8-lane sharded render of it."""
    rng = np.random.default_rng(3)
    env = j_plane(rng, n=500, size=1.5)
    b1 = j_box(rng, n=200, center=(0.05, 0, 0.08), object_id=1)
    b2 = j_box(rng, n=160, center=(-0.1, 0.05, 0.05), object_id=2, rgb=(0.2, 0.5, 0.9),
               half_extents=(0.04, 0.04, 0.05))
    j_scene = j_merge([env, b1, b2])
    j_cam = JCamera.look_at(**VIEW)
    padded = j_scene.padded(j_scene.num_splats + (-j_scene.num_splats) % 8)
    want = j_sharded(padded, j_cam, j_make_mesh((8,), ("splat",)), background=BG, max_objects=K,
                     chunk=128)
    return j_scene, j_cam, as_torch(j_scene), Camera.look_at(**VIEW, device="cpu"), want


# -- the mesh ------------------------------------------------------------------------


def test_make_mesh_shapes_lanes_and_errors(monkeypatch):
    mesh = make_mesh((2, 4), ("scene", "splat"), ["cpu"] * 8)
    assert mesh.shape == {"scene": 2, "splat": 4} and mesh.size == 8
    assert mesh.devices.shape == (2, 4) and mesh.devices.dtype == object
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    assert len(mesh.lanes()) == 8 and len(mesh.lanes((1,))) == 4
    assert all(lane.stream is None for lane in mesh.lanes())  # no stream on the CPU
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert make_mesh(devices=["cpu"] * 3).shape == {"scene": 3}  # the default axis
    with pytest.raises(ValueError, match=r"mesh \(3,\) does not cover 4 devices"):
        make_mesh((3,), ("scene",), ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not match axes"):
        make_mesh((2, 2), ("scene",), ["cpu"] * 4)
    with pytest.raises(dataclasses_error()):
        mesh.axis_names = ("x",)  # frozen
    # devices=None is every visible card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def dataclasses_error():
    import dataclasses

    return dataclasses.FrozenInstanceError


def test_split_batch_and_replicate():
    mesh = cpu_mesh(3, "scene")
    tree = {"a": torch.arange(10), "cam": Camera.look_at(**VIEW, device="cpu"),
            "s": rb.RigidBodyState.rest(torch.zeros(10, 2, 3), torch.ones(10, 2, 4), device="cpu")}
    with pytest.raises(ValueError, match="leading axes differ"):
        split_batch(tree, mesh, "scene")  # the camera's 3x3 does not carry the batch axis
    del tree["cam"]
    parts = split_batch(tree, mesh, "scene")
    assert [p["a"].tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert [p["s"].pos.shape[0] for p in parts] == [4, 3, 3]
    assert [(s.start, s.stop) for s in lane_slices(10, 3)] == [(0, 4), (4, 7), (7, 10)]
    assert [(s.start, s.stop) for s in lane_slices(2, 4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]
    with pytest.raises(ValueError, match="1-D 'batch' mesh"):
        split_batch(tree, mesh, "batch")
    copies = replicate(tree, mesh)
    assert len(copies) == 3 and copies[0] is copies[1]  # lanes of one device share the copy
    assert torch.equal(copies[2]["a"], tree["a"])


def test_map_lanes_runs_each_item_in_its_lane_and_raises():
    lanes = cpu_mesh(4, "scene").lanes()
    seen = map_lanes(lanes, lambda lane, x: (x * x, lane.device.type), [1, 2, 3])
    assert seen == [(1, "cpu"), (4, "cpu"), (9, "cpu")]
    with pytest.raises(ValueError, match="5 items for 4 lanes"):
        map_lanes(lanes, lambda lane, x: x, range(5))

    ran = []

    def boom(lane, x):
        ran.append(x)
        if x == 2:
            raise KeyError("lane failed")
        return x

    with pytest.raises(KeyError, match="lane failed"):
        map_lanes(lanes, boom, [1, 2, 3])
    assert ran == [1, 2]  # in lane order, up to the call that failed


def test_map_lanes_takes_the_lanes_in_order():
    """Lanes run one after the other in lane order, and fewer items than
    lanes use the first lanes only."""
    lanes = cpu_mesh(4, "scene").lanes()
    order = []
    slot = lambda lane: next(i for i, other in enumerate(lanes) if other is lane)
    assert map_lanes(lanes, lambda lane, x: order.append(x) or slot(lane), "ab") == [0, 1]
    assert order == ["a", "b"]
    assert map_lanes(lanes, lambda lane, x: x, []) == []


# -- (a) the splat-sharded render ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "golden", "pallas", "tiled"])
@pytest.mark.parametrize("n_lanes", [1, 2, 4, 8, 3])
def test_splat_sharded_matches_reference_and_unsharded(scene, n_lanes, backend):
    """(a) on 1, 2, 4, 8 and 3 CPU lanes, with the tile compositor ("cuda",
    and "pallas", the reference's name for it; "tiled" caps each shard's
    segments at 1024 entries, more than any holds here) and with the
    golden compositor per shard: <= 1e-5 in every field against the JAX
    package's 8-lane render and against the port's unsharded ``rasterize``;
    a second render on the same mesh is bitwise equal."""
    _, _, t_scene, t_cam, want = scene
    mesh = cpu_mesh(n_lanes)
    got = rasterize_splat_sharded(t_scene, t_cam, mesh, background=BG, max_objects=K, chunk=128,
                                  backend=backend)
    assert got.rgb.shape == (40, 48, 3) and got.amodal.shape == (40, 48, K)
    assert max_diff(want, got) <= ATOL
    assert max_diff(rasterize(t_scene, t_cam, background=BG, max_objects=K), got) <= ATOL
    again = rasterize_splat_sharded(t_scene, t_cam, mesh, background=BG, max_objects=K, chunk=128,
                                    backend=backend)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sharded_backends_and_mesh_are_checked(scene):
    _, _, t_scene, t_cam, _ = scene
    with pytest.raises(ValueError, match="'golden'.*'cuda'.*'tiled'"):
        rasterize_splat_sharded(t_scene, t_cam, cpu_mesh(2), backend="mosaic")
    with pytest.raises(ValueError, match="1-D 'splat' mesh"):
        rasterize_splat_sharded(t_scene, t_cam, cpu_mesh(2, "scene"))
    # the reference's two raises are gone: 860 splats on 3 lanes, an odd count
    assert t_scene.num_splats % 3 != 0
    rasterize_splat_sharded(t_scene, t_cam, cpu_mesh(3), max_objects=K)


@pytest.mark.parametrize("backend", ["cuda", "golden"])
def test_empty_shard_is_the_identity(scene, backend):
    """A shard without a valid splat composites to zeros and two ones, and
    combining it changes nothing: a cloud padded to twice its size renders on
    2 lanes (the second shard all padding) exactly as on 1."""
    _, _, t_scene, t_cam, _ = scene
    proj = project_gaussians(t_scene, t_cam)
    dead = ProjectedGaussians(*(f[:64] for f in proj))._replace(valid=torch.zeros(64, dtype=torch.bool))
    ident = identity_payload(48, 40, K, "cpu")
    assert ident.shape == (40, 48, num_channels(K))
    assert float(ident[..., :-2].abs().max()) == 0.0 and float(ident[..., -2:].min()) == 1.0
    assert torch.equal(_local_render(backend, dead, 48, 40, K, 128), ident)
    none = ProjectedGaussians(*(f[:0] for f in proj))
    assert torch.equal(_local_render(backend, none, 48, 40, K, 128), ident)

    padded = t_scene.padded(2 * t_scene.num_splats)
    one = rasterize_splat_sharded(t_scene, t_cam, cpu_mesh(1), background=BG, max_objects=K,
                                  backend=backend)
    two = rasterize_splat_sharded(padded, t_cam, cpu_mesh(2), background=BG, max_objects=K,
                                  backend=backend)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    # more lanes than splats: the trailing lanes get nothing
    tiny = GaussianCloudSlice(t_scene, 3)
    few = rasterize_splat_sharded(tiny, t_cam, cpu_mesh(8), background=BG, max_objects=K, backend=backend)
    assert max_diff(rasterize(tiny, t_cam, background=BG, max_objects=K), few) <= ATOL


def GaussianCloudSlice(cloud, n):
    import dataclasses

    return dataclasses.replace(cloud, **{f.name: getattr(cloud, f.name)[-n:]
                                         for f in dataclasses.fields(cloud)})


def test_equal_depths_across_a_shard_boundary_keep_the_unsharded_order():
    """Two splats of equal depth bits composite in splat order (the stable
    sorts of binning and of the global depth order).  A box cloud and its
    recoloured copy give pairs of equal depth; on 3 lanes a boundary falls
    inside a pair, and the render still equals the unsharded one."""
    rng = np.random.default_rng(2)
    box = make_box_cloud(rng, n=175, center=(0, 0, 0.08), object_id=1, device="cpu")
    twin = box.replace(f_dc=box.f_dc.flip(-1) * 0.5, object_id=torch.full_like(box.object_id, 2))
    cloud = merge([box, twin])
    cam = Camera.look_at(**VIEW, device="cpu")
    proj = project_gaussians(cloud, cam)
    assert bool(proj.valid.all())
    order = torch.argsort(proj.depth, stable=True)
    depth = proj.depth[order]
    cuts = [s.stop for s in lane_slices(cloud.num_splats, 3)[:-1]]
    assert any(float(depth[c - 1]) == float(depth[c]) for c in cuts), cuts  # a pair is split
    assert bool((order[0::2] + 175 == order[1::2]).all())  # each pair in splat order
    want = rasterize(cloud, cam, background=BG, max_objects=K)
    for backend in ("cuda", "golden"):
        got = rasterize_splat_sharded(cloud, cam, cpu_mesh(3), background=BG, max_objects=K,
                                      backend=backend)
        assert max_diff(want, got) <= ATOL
    # the order matters here: the twins swapped render differently
    swapped = rasterize(merge([twin, box]), cam, background=BG, max_objects=K)
    assert float((swapped.rgb - want.rgb).abs().max()) > 1e-3


def test_combine_tree_is_the_butterflys():
    """(0,1)(2,3) then (01,23); an odd tail moves up as it is."""
    calls = []

    class P:
        def __init__(self, name):
            self.name = name

    import pegasus_tpu_torch.parallel.sharded_render as sr

    real = sr.over
    sr.over = lambda a, b, k: calls.append((a.name, b.name)) or P(a.name + b.name)
    try:
        assert combine_in_order([P(c) for c in "abcde"], K).name == "abcde"
    finally:
        sr.over = real
    assert calls == [("a", "b"), ("c", "d"), ("ab", "cd"), ("abcd", "e")]


# -- (b) the hybrid scene x splat mesh -------------------------------------------------------


def test_hybrid_scene_by_splat_mesh(scene):
    """(b) four jittered scenes on a (2, 4) mesh: each equals its own 4-lane
    sharded render bitwise (scene rows never mix), and the JAX package's
    hybrid render of the same scenes to 1e-5."""
    j_scene, j_cam, _, t_cam, _ = scene
    rng = np.random.default_rng(11)
    pad = (-j_scene.num_splats) % 4
    j_scenes = []
    for _ in range(4):
        moved = j_scene.replace(xyz=j_scene.xyz + jnp.asarray(
            rng.normal(size=j_scene.xyz.shape) * 0.01, jnp.float32))
        j_scenes.append(moved.padded(j_scene.num_splats + pad))
    clouds = jax.tree.map(lambda *x: jnp.stack(x), *j_scenes)
    cams = jax.tree.map(lambda *x: jnp.stack(x), *([j_cam] * 4))
    want = jax.jit(lambda cl, c: j_sharded_batch(
        cl, c, j_make_mesh((2, 4), ("scene", "splat")), width=48, height=40, background=BG,
        max_objects=K, chunk=128))(clouds, cams)

    t_scenes = [as_torch(s) for s in j_scenes]
    mesh = make_mesh((2, 4), ("scene", "splat"), ["cpu"] * 8)
    got = rasterize_splat_sharded_batch(t_scenes, [t_cam] * 4, mesh, 48, 40, background=BG,
                                        max_objects=K, chunk=128)
    assert got.rgb.shape == (4, 40, 48, 3) and got.amodal.shape == (4, 40, 48, K)
    for i in range(4):
        own = rasterize_splat_sharded(t_scenes[i], t_cam, cpu_mesh(4), background=BG, max_objects=K,
                                      chunk=128)
        assert all(torch.equal(getattr(got, f)[i], getattr(own, f)) for f in FIELDS), i
        for f in FIELDS:
            diff = np.abs(np.asarray(getattr(want, f)[i]) - getattr(got, f)[i].numpy()).max()
            assert diff <= ATOL, (i, f, diff)
    assert float((got.rgb[0] - got.rgb[1]).abs().max()) > 1e-3  # the scenes differ
    with pytest.raises(ValueError, match=r"scene batch \(3\) must divide over 2"):
        rasterize_splat_sharded_batch(t_scenes[:3], [t_cam] * 3, mesh, 48, 40)
    with pytest.raises(ValueError, match="mesh"):
        rasterize_splat_sharded_batch(t_scenes, [t_cam] * 4, cpu_mesh(4), 48, 40)


# -- validate ------------------------------------------------------------------------------------


def test_compare_backends_and_psnr(scene):
    """``psnr_db`` as the reference computes it (1e-9 dB), and the 40 dB gate
    on the port's fast backends, the sharded render included."""
    _, _, t_scene, t_cam, _ = scene
    rng = np.random.default_rng(0)
    a, b = rng.random((8, 9, 3)), rng.random((8, 9, 3))
    assert abs(psnr_db(torch.tensor(a), torch.tensor(b)) - j_psnr_db(a, b)) <= 1e-9
    assert psnr_db(a, a) == float("inf") and abs(psnr_db(a, b, peak=2.0) - j_psnr_db(a, b, peak=2.0)) <= 1e-9
    for backend, kwargs in (("cuda", {}), ("sharded", {"mesh": cpu_mesh(4)}), ("pallas", {}),
                            ("tiled", {})):
        report = compare_backends(t_scene, t_cam, backend=backend, max_objects=K, background=BG, **kwargs)
        assert report["backend"] == backend and report["pass_40db"], report
        assert report["min_psnr_db"] > 100 and report["alpha_max_err"] <= ATOL
        assert report["vis_weights_mask_disagree"] == 0.0
    with pytest.raises(ValueError, match="unknown backend"):
        compare_backends(t_scene, t_cam, backend="mosaic")


# -- (g) scene variants over a mesh -----------------------------------------------------------------


def test_generate_scene_variants_over_a_mesh_equals_one_device():
    """(g) V = 5 variants on 2 and on 4 CPU lanes equal ``mesh=None`` bitwise
    (one ``simulate_batch`` per device, the lanes' renders in variant order)."""
    rng = np.random.default_rng(0)
    env = make_plane_cloud(rng, n=300, size=1.5, device="cpu")
    objs = [make_box_cloud(rng, n=80, object_id=1, device="cpu"),
            make_box_cloud(rng, n=80, object_id=2, rgb=(0.2, 0.6, 0.9), device="cpu")]
    template = SceneTemplate.build(env, objs)
    half = np.asarray((0.05, 0.05, 0.08), np.float32)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    t = lambda x: torch.tensor(x)
    params = rb.RigidBodyParams(
        inv_mass=t(np.array([0, 5, 5], np.float32)), inv_inertia=t(np.array([[0] * 3, [900] * 3, [900] * 3], np.float32)),
        points=t(np.tile((signs * half)[None], (3, 1, 1))), point_mask=t(np.ones((3, 8), bool)),
        radius=t(np.full(3, float(np.linalg.norm(half)), np.float32)), friction=t(np.full(3, 0.5, np.float32)),
        restitution=t(np.zeros(3, np.float32)), body_mask=t(np.ones(3, bool)),
        half_extents=t(np.tile(half, (3, 1))),
    )
    cam = Camera.look_at(**dict(VIEW, eye=(0.6, 0.5, 0.7)), device="cpu")
    kwargs = dict(n_steps=12, seed=3, max_objects=4, drop_height=(0.2, 0.3), device="cpu")
    want = generate_scene_variants(template, params, cam, 5, **kwargs)
    calls = []
    real = rb.simulate_batch
    rb.simulate_batch = lambda p, s, **kw: calls.append(s.pos.shape[0]) or real(p, s, **kw)
    try:
        for n_lanes in (2, 4, 8):
            got = generate_scene_variants(template, params, cam, 5, mesh=cpu_mesh(n_lanes, "scene"), **kwargs)
            assert all(torch.equal(a, b) for a, b in zip(want, got)), n_lanes
    finally:
        rb.simulate_batch = real
    assert calls == [5, 5, 5]  # one drop per device, whatever the lanes
    assert want.rgb.shape == (5, 40, 48, 3) and float((want.rgb[0] - want.rgb[1]).abs().max()) > 0.01
