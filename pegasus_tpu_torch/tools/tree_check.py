"""Hold two checkouts of the repo against each other on the card: the BOP
trees that ``PEGASUS.generate_dataset`` and ``run_generation(mesh=)`` write,
the outputs of ``generate_scene_variants`` and the compositor kernels'
outputs at the training shape.

    python3 pegasus_tpu_torch/tools/tree_check.py dump ROOT OUT [FRAME_CHUNK]
    python3 pegasus_tpu_torch/tools/tree_check.py compare OUT_A OUT_B

``dump`` runs the package of the checkout at ROOT (a ``git archive`` of
another commit unpacked into a git-ignored directory, or ``.``) in a child
process: it builds the smoke's synthetic dataset (150k-splat environment,
six 10k-splat objects), writes the static (40 frames) and dynamic (8 frames)
640x480 scenes of ``chip_smoke.py``'s phase 5, with their preview videos,
under OUT/trees, at FRAME_CHUNK frames per chunk (omitted: the checkout's default, for a
checkout that takes no ``frame_chunk``), then on 4 lanes of the card 2
static scenes of 10 x 4 frames and 2 dynamic of 2 x 4 through
``run_generation(mesh=)`` (phase 13's chunk turns, ``frame_chunk`` as
above) under OUT/trees/sharded, and saves ``generate_scene_variants`` of
V = 20 on 4 lanes (a 60k-splat plane and three boxes, 640x480) and the
forward kernel's output and partials and K3's rows at the training shape
to OUT/kernels.pt (of the partials, the rows the kernel writes).
``compare`` prints how many files differ (byte for byte; videos by their
decoded frames, with cv2) and whether each tensor is bitwise equal, and
exits 1 if anything differs.  Needs one CUDA
device; run both dumps and the compare in one call, on one card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def _dump(root: str, out: str, frame_chunk: str | None) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    import pegasus_tpu_torch
    from pegasus_tpu_torch.io.png import _load_native
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.composite_vjp import composite_tiles_backward
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import CHUNK_ENTRIES, composite_tiles, tile_items
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS, build_synthetic_dataset

    if not Path(pegasus_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {pegasus_tpu_torch.__file__}, not the package under {root}")
    _load_native()  # before the writer's threads
    dev = torch.device("cuda:0")
    out = Path(out)
    data = build_synthetic_dataset(out / "data", object_names=[n for n, _ in SMOKE_OBJECTS],
                                   env_splats=150_000, obj_splats=10_000)
    kw = {} if frame_chunk is None else {"frame_chunk": int(frame_chunk)}
    for mode, n_cams in (("static", 10), ("dynamic", 2)):
        peg = cs.scene_pegasus(data, out / "trees", mode, mode, n_cams, 4, dev, **kw)
        peg.generate_dataset(cs.MODALITIES, save_bop=True, save_video=True)
        peg.save2bop()
    _sharded(data, out / "trees" / "sharded", dev, kw)
    variants = _variants(dev)
    bins = bin_splats(project_gaussians(cs.train_box_cloud(dev), cs.train_camera(dev)),
                      cs.TRAIN_SIZE, cs.TRAIN_SIZE)
    fwd, partials = composite_tiles(bins, cs.TRAIN_SIZE, cs.TRAIN_SIZE, 1, return_partials=True)
    g = torch.randn(fwd.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    bwd = composite_tiles_backward(bins, g, fwd, partials, cs.TRAIN_SIZE, cs.TRAIN_SIZE, 1)
    # the rows the kernel writes: the items of tiles of more than one item
    # (the rest of the buffer is never written)
    n, _ = tile_items(bins, CHUNK_ENTRIES)
    item_tile = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    written = partials[: item_tile.numel()][n[item_tile] > 1]
    torch.save({"fwd": fwd.cpu(), "partials": written.cpu(), "bwd": bwd.cpu(),
                **{f"variants.{k}": v.cpu() for k, v in variants._asdict().items()}},
               out / "kernels.pt")


def _sharded(data: Path, base: Path, dev, kw: dict) -> None:
    """2 static scenes, then (resuming) 2 dynamic, on 4 lanes of ``dev``."""
    import chip_smoke as cs
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.generate import run_generation
    from pegasus_tpu_torch.parallel.mesh import make_mesh

    env, objs = cs.smoke_assets(data)
    mesh = make_mesh(devices=[dev] * 4)
    for mode, num_scenes, num_cameras, seed in (("static", 2, 10, 21), ("dynamic", 4, 2, 22)):
        config = GenerationConfig(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            dataset_base_path=str(base), dataset_name="chunked", num_scenes=num_scenes,
            min_num_objects=3, max_num_objects=6, mode=mode, render_width=cs.WIDTH,
            render_height=cs.HEIGHT, num_cameras=num_cameras, num_camera_interpolation_steps=4,
            camera_trajectory_mode="random", render_data_points=list(cs.MODALITIES),
            simulation_steps=cs.SIM_STEPS, save_video=False, seed=seed, **kw,
        )
        run_generation(config, [env], objs, mesh=mesh)
    (base / "chunked" / "generation_stats.jsonl").unlink()  # seconds
    (base / "chunked" / "generation_config.json").unlink()  # frame_chunk and the paths


def _variants(dev):
    """``generate_scene_variants`` of V = 20 drops of 100 steps on 4 lanes."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from pegasus_tpu_torch.parallel.mesh import make_mesh
    from pegasus_tpu_torch.parallel.scene_batch import generate_scene_variants
    from pegasus_tpu_torch.physics import rigid_body as rb
    from pegasus_tpu_torch.scene.composition import SceneTemplate
    from pegasus_tpu_torch.testing import make_box_cloud, make_plane_cloud

    rng = np.random.default_rng(9)
    half = np.asarray((0.06, 0.06, 0.03), np.float32)
    env = make_plane_cloud(rng, n=60_000, size=2.0, device=dev)
    objs = [make_box_cloud(rng, n=5_000, half_extents=tuple(half), object_id=i + 1, device=dev)
            for i in range(3)]
    b = len(objs) + 1
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    t = lambda a: torch.tensor(a, device=dev)
    params = rb.RigidBodyParams(
        inv_mass=t(np.array([0.0] + [5.0] * (b - 1), np.float32)),
        inv_inertia=t(np.array([[0.0] * 3] + [[900.0] * 3] * (b - 1), np.float32)),
        points=t(np.tile((signs * half)[None], (b, 1, 1))), point_mask=t(np.ones((b, 8), bool)),
        radius=t(np.full(b, np.linalg.norm(half), np.float32)),
        friction=t(np.full(b, 0.5, np.float32)), restitution=t(np.zeros(b, np.float32)),
        body_mask=t(np.ones(b, bool)), half_extents=t(np.tile(half, (b, 1))),
    )
    return generate_scene_variants(SceneTemplate.build(env, objs), params,
                                   cs.bench_cameras(dev)["orbit"], 20, n_steps=100, seed=5,
                                   max_objects=b, mesh=make_mesh(devices=[dev] * 4))


def _same_file(a: Path, b: Path) -> bool:
    """Equal bytes; videos: the same frames when decoded."""
    if a.suffix != ".mp4":
        return a.read_bytes() == b.read_bytes()
    import cv2
    import numpy as np

    ca, cb = cv2.VideoCapture(str(a)), cv2.VideoCapture(str(b))
    try:
        while True:
            (ok_a, fa), (ok_b, fb) = ca.read(), cb.read()
            if ok_a != ok_b or (ok_a and not np.array_equal(fa, fb)):
                return False
            if not ok_a:
                return True
    finally:
        ca.release()
        cb.release()


def compare(a: Path, b: Path) -> bool:
    import torch

    files = sorted(p.relative_to(a / "trees") for p in (a / "trees").rglob("*") if p.is_file())
    if files != sorted(p.relative_to(b / "trees") for p in (b / "trees").rglob("*") if p.is_file()):
        print(f"{a} vs {b}: the trees hold other files", flush=True)
        return False
    differ = [str(f) for f in files if not _same_file(a / "trees" / f, b / "trees" / f)]
    ka, kb = torch.load(a / "kernels.pt"), torch.load(b / "kernels.pt")
    same = {k: torch.equal(ka[k], kb[k]) for k in ka}
    videos = sum(f.suffix == ".mp4" for f in files)
    print(f"{a.name} vs {b.name}: {len(files)} files ({videos} videos), {len(differ)} differ {differ[:10]}; "
          f"kernel outputs bitwise equal {same}", flush=True)
    return not differ and all(same.values())


def main(argv: list[str]) -> int:
    if argv[0] == "_dump":
        _dump(*argv[1:3], argv[3] if len(argv) > 3 else None)
        return 0
    if argv[0] == "dump":
        return subprocess.run([sys.executable, __file__, "_dump", *argv[1:]]).returncode
    return 0 if compare(Path(argv[1]), Path(argv[2])) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
