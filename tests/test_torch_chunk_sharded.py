"""The frame chunk on the batched and sharded generation, and the reference's
keywords of their entry points.

``run_generation(mesh=)`` renders each lane's scene in chunks of
``config.frame_chunk`` frames and ``generate_scene_variants`` each lane's
variants in chunks of ``scene_batch.VARIANT_CHUNK``: one projection, one
binning host read (``bin_splats.host_reads``) and one compositor launch per
chunk.  Every frame must get the bits that rendering it alone gives, so:

* the BOP trees of ``run_generation(mesh=)`` on 2 CPU lanes at
  ``frame_chunk`` 1, 3 and 8 are byte-identical (2 cameras x 3 steps = 6
  frames per scene: chunks of 1, 3 + 3 and 6), static and dynamic, every
  file but ``generation_stats.jsonl`` and ``generation_config.json``;
* ``generate_scene_variants`` at V = 5 with ``VARIANT_CHUNK`` 1, 3 and 8, on
  one device and on 2 CPU lanes, gives equal results (``torch.equal`` on
  every field), each variant equal to ``rasterize`` of it alone;
* host reads are one per chunk.

Then the repairs: ``run_generation_sharded`` and ``generate_scene_variants``
take the reference's parameters in the reference's order (a given
``rasterize_fn`` renders each frame or variant, with ``rasterize_kwargs``),
``pegasus_tpu_torch.parallel``
exports the reference's names (``split_batch`` for ``shard_batch``), and
``utils/sh.py`` has the Inria spellings ``RGB2SH`` / ``SH2RGB``.  Against the
JAX package through the chunk path:
``tests/test_torch_generation_sharded.py::test_sharded_generation_matches_reference``
and ``tests/test_torch_generate.py::test_generate_scene_variants_matches_reference``.

The module imports nothing of JAX at its top: ``tests/test_torch_chunk_sharded_card.py``
takes its cases from here.
"""

import inspect

import numpy as np
import pytest
import torch

import pegasus_tpu_torch.parallel as tparallel
from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.generate import run_generation
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.parallel import scene_batch
from pegasus_tpu_torch.parallel.generation import run_generation_sharded
from pegasus_tpu_torch.parallel.mesh import lane_slices, make_mesh
from pegasus_tpu_torch.physics import rigid_body as rb
from pegasus_tpu_torch.scene.composition import SceneTemplate, pose_scene
from pegasus_tpu_torch.testing import build_synthetic_dataset, make_box_cloud, make_plane_cloud
from pegasus_tpu_torch.utils import quaternion as quat
from pegasus_tpu_torch.utils import sh as tsh

torch.set_num_threads(1)

OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107))
CHUNKS = (1, 3, 8)
SKIP_FILES = {"generation_stats.jsonl", "generation_config.json"}  # seconds, and the chunk itself
N_VARIANTS = 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("chunk_sharded_assets")
    build_synthetic_dataset(path, object_names=[n for n, _ in OBJECTS])
    return path


def assets(root):
    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3))
    return env, [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS]


def config(root, out, mode, frame_chunk, **over):
    """``tests/test_torch_generation_sharded.py:_config``'s scene at 2
    cameras x 3 steps = 6 frames."""
    fields = dict(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        dataset_name="chunk_run", dataset_base_path=str(out), num_scenes=3, min_num_objects=1,
        max_num_objects=2, render_width=48, render_height=40, num_cameras=2,
        num_camera_interpolation_steps=3, simulation_steps=20, mode=mode,
        camera_trajectory_mode="random", seed=12, save_video=False, frame_chunk=frame_chunk,
    )
    fields.update(over)
    return GenerationConfig(**fields)


def tree(root):
    """Every file's bytes but the stats and the config, by relative path."""
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.name not in SKIP_FILES}


def differing(trees) -> dict:
    """Per chunk size, the files that differ from the trees at chunk 1."""
    base = trees[CHUNKS[0]]
    out = {}
    for c, t in trees.items():
        assert t.keys() == base.keys(), c
        out[c] = [str(f) for f, b in base.items() if t[f] != b]
    return out


def rise(counters, before) -> tuple:
    return tuple(now - then for now, then in zip(counters(), before))


def sharded_trees(root, tmp_path, mode, mesh, counters):
    """``run_generation(mesh=)`` at each chunk size -> (trees, {C: (the rise
    of each of ``counters()``, scenes written)})."""
    env, objs = assets(root)
    trees, rises = {}, {}
    for c in CHUNKS:
        before = counters()
        stats = run_generation(config(root, tmp_path / f"c{c}", mode, c), [env], objs, mesh=mesh)
        rises[c] = (rise(counters, before), len(stats.records))
        trees[c] = tree(tmp_path / f"c{c}")
    return trees, rises


def chunks_of(n_frames: int, chunk: int) -> int:
    return -(-n_frames // chunk)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_sharded_trees_identical_across_frame_chunk(root, tmp_path, mode):
    trees, rises = sharded_trees(root, tmp_path, mode, make_mesh(devices=["cpu"] * 2),
                                 lambda: (bin_splats.host_reads,))
    assert len(trees[1]) > 30
    assert differing(trees) == {c: [] for c in CHUNKS}
    for c, ((reads,), scenes) in rises.items():
        assert scenes == 3 and reads == scenes * chunks_of(6, c), (c, reads)  # one read per chunk


def variant_case(device):
    """``tests/test_torch_parallel.py``'s V-variant scene: a plane and two
    boxes, drops of 12 steps, one 48x40 camera; -> (template, params, cam)."""
    rng = np.random.default_rng(0)
    env = make_plane_cloud(rng, n=300, size=1.5, device=device)
    objs = [make_box_cloud(rng, n=80, object_id=1, device=device),
            make_box_cloud(rng, n=80, object_id=2, rgb=(0.2, 0.6, 0.9), device=device)]
    half = np.asarray((0.05, 0.05, 0.08), np.float32)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    t = lambda x: torch.tensor(x, device=device)
    params = rb.RigidBodyParams(
        inv_mass=t(np.array([0, 5, 5], np.float32)),
        inv_inertia=t(np.array([[0] * 3, [900] * 3, [900] * 3], np.float32)),
        points=t(np.tile((signs * half)[None], (3, 1, 1))), point_mask=t(np.ones((3, 8), bool)),
        radius=t(np.full(3, float(np.linalg.norm(half)), np.float32)),
        friction=t(np.full(3, 0.5, np.float32)), restitution=t(np.zeros(3, np.float32)),
        body_mask=t(np.ones(3, bool)), half_extents=t(np.tile(half, (3, 1))),
    )
    cam = Camera.look_at(eye=(0.6, 0.5, 0.7), target=(0, 0, 0.05), up=(0, 0, 1), fovx=np.deg2rad(55),
                         fovy=np.deg2rad(45), width=48, height=40, device=device)
    return SceneTemplate.build(env, objs), params, cam


VARIANT_KWARGS = dict(n_steps=12, seed=3, max_objects=4, drop_height=(0.2, 0.3))


def variants_across_chunks(monkeypatch, device, mesh, counters):
    """``generate_scene_variants`` at each ``VARIANT_CHUNK`` -> ({C: result},
    {C: the rise of each of ``counters()``}, the case)."""
    case = variant_case(device)
    results, rises = {}, {}
    for c in CHUNKS:
        monkeypatch.setattr(scene_batch, "VARIANT_CHUNK", c)
        before = counters()
        results[c] = scene_batch.generate_scene_variants(*case, N_VARIANTS, mesh=mesh, device=device,
                                                         **VARIANT_KWARGS)
        rises[c] = rise(counters, before)
    return results, rises, case


def assert_variants_equal_alone(res, case):
    """Each variant bitwise equal to ``rasterize`` of it alone (the loop the
    chunk replaced), and the chunk sizes' results to each other."""
    template, _, cam = case
    body_R = quat.quat_to_rotmat(res.final_rot)
    body_R[:, 0] = torch.eye(3, device=body_R.device)
    body_t = res.final_pos.clone()
    body_t[:, 0] = 0.0
    for v in range(N_VARIANTS):
        alone = rasterize(pose_scene(template, body_R[v], body_t[v]), cam, max_objects=4)
        for name in scene_batch.RENDER_FIELDS:
            assert torch.equal(getattr(res, name)[v], getattr(alone, name)), (v, name)


@pytest.mark.parametrize("lanes", [None, 2])
def test_variants_equal_across_variant_chunk(monkeypatch, lanes):
    mesh = None if lanes is None else make_mesh(devices=["cpu"] * lanes)
    results, reads, case = variants_across_chunks(monkeypatch, "cpu", mesh,
                                                  lambda: (bin_splats.host_reads,))
    for c, res in results.items():
        assert all(torch.equal(a, b) for a, b in zip(results[1], res)), c
    assert_variants_equal_alone(results[8], case)
    cuts = lane_slices(N_VARIANTS, lanes or 1)
    assert reads == {c: (sum(chunks_of(cut.stop - cut.start, c) for cut in cuts),) for c in CHUNKS}
    assert float((results[1].rgb[0] - results[1].rgb[1]).abs().max()) > 0.01  # the drops differ


# -- the repairs: the reference's keywords, exports and spellings ---------------------------------


@pytest.mark.parametrize("name", ["run_generation_sharded", "generate_scene_variants"])
def test_entry_points_take_the_reference_parameters_in_order(name):
    from pegasus_tpu.parallel import generation as j_generation
    from pegasus_tpu.parallel import scene_batch as j_scene_batch

    ref = {"run_generation_sharded": j_generation, "generate_scene_variants": j_scene_batch}[name]
    port = getattr(tparallel, name)
    want = list(inspect.signature(getattr(ref, name)).parameters)
    got = list(inspect.signature(port).parameters)
    assert got[: len(want)] == want
    for extra in got[len(want):]:  # the port's own parameters come after, with defaults
        assert inspect.signature(port).parameters[extra].default is not inspect.Parameter.empty


def test_variant_keywords_accepted_as_none_and_refused_otherwise():
    template, params, cam = variant_case("cpu")
    mesh = make_mesh(devices=["cpu"] * 2)
    kwargs = dict(n_steps=4, max_objects=4)
    want = scene_batch.generate_scene_variants(template, params, cam, 3, mesh=mesh, seed=1, **kwargs)
    # the reference's positional order: ..., seed, mesh, max_objects, rasterize_fn, rasterize_kwargs
    got = scene_batch.generate_scene_variants(template, params, cam, 3, 4, (0.25, 0.45), (0.15, 0.15),
                                              1, mesh, 4, None, {})
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    # a given rasterize_fn renders each variant, called as the reference
    # calls it; rasterize of one variant has the bits of the chunk launch
    calls = []

    def counted(scene, cam, max_objects, **kw):
        calls.append((max_objects, kw))
        return rasterize(scene, cam, max_objects=max_objects, **kw)

    given = scene_batch.generate_scene_variants(template, params, cam, 3, mesh=mesh, seed=1,
                                                rasterize_fn=counted,
                                                rasterize_kwargs={"scaling_modifier": 1.0}, **kwargs)
    assert calls == [(4, {"scaling_modifier": 1.0})] * 3
    assert all(torch.equal(a, b) for a, b in zip(want, given))


def test_sharded_keywords_accepted_as_none_and_refused_otherwise(root, tmp_path):
    env, objs = assets(root)
    cfg = config(root, tmp_path / "positional", "static", 8, num_scenes=1, num_cameras=1,
                 num_camera_interpolation_steps=2)
    # the reference's positional order: config, env_list, obj_list, mesh, rasterize_fn; a mesh
    # landing elsewhere would leave mesh=None, a mesh over the cards, which raises here
    stats = run_generation_sharded(cfg, [env], objs, make_mesh(devices=["cpu"]), None)
    assert [r["frames"] for r in stats.records] == [2]
    # a given rasterize_fn renders every frame; rasterize of one frame has
    # the bits of the chunk launch, so the tree is the same
    calls = []

    def counted(scene, cam, **kw):
        calls.append(kw["max_objects"])
        return rasterize(scene, cam, **kw)

    given = config(root, tmp_path / "given", "static", 8, num_scenes=1, num_cameras=1,
                   num_camera_interpolation_steps=2)
    run_generation_sharded(given, [env], objs, make_mesh(devices=["cpu"]), counted, {})
    assert len(calls) == 2
    assert tree(tmp_path / "given") == tree(tmp_path / "positional")


def test_parallel_exports_the_reference_names():
    from pegasus_tpu import parallel as j_parallel

    assert set(tparallel.__all__) == set(j_parallel.__all__) - {"shard_batch"} | {"split_batch"}
    assert not hasattr(tparallel, "shard_batch")  # split_batch returns a list of per-lane trees
    assert "shard_batch" in tparallel.split_batch.__doc__
    for name in tparallel.__all__:
        assert callable(getattr(tparallel, name)), name
    assert tparallel.run_generation_sharded is run_generation_sharded
    assert tparallel.generate_scene_variants is scene_batch.generate_scene_variants


def test_sh_inria_spellings_match_the_reference():
    import jax.numpy as jnp

    from pegasus_tpu.utils import sh as jsh

    x = np.random.default_rng(4).uniform(-0.5, 1.5, (64, 3)).astype(np.float32)
    assert tsh.RGB2SH is tsh.rgb2sh and tsh.SH2RGB is tsh.sh2rgb
    for port, ref in ((tsh.RGB2SH, jsh.RGB2SH), (tsh.SH2RGB, jsh.SH2RGB)):
        np.testing.assert_allclose(port(torch.tensor(x)).numpy(), np.asarray(ref(jnp.asarray(x))),
                                   atol=1e-6, rtol=0)
