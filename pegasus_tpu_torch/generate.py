"""Top-level dataset generation loop, as a library + CLI.

Port of ``pegasus_tpu/generate.py``: models export, per scene physics ->
setup -> render -> BOP, then gt-info and scene-wise -> NDDS conversion,
with per-scene retry, resume from finished scenes and structured
throughput stats.  The sequential path runs on one torch device
(``device``, default the card).  With ``mesh=`` (a ``parallel.mesh.Mesh`` of
lanes; ``--sharded`` on the CLI: one lane per visible card) scenes are
generated in mesh-size batches by ``parallel/generation.py``: one batched
drop per device, one render lane per scene.  More lanes on one card are
asked for through the library argument, e.g.
``mesh=make_mesh(devices=["cuda:0"] * 4)``.

Usage:
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.generate import run_generation
    run_generation(config, env_list, obj_list)

or:  python -m pegasus_tpu_torch.generate --config config.json
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.io.bop_writer import (
    calculate_gt_info,
    convert_scenewise_to_imagewise_ndds,
    write_models,
    write_scene_gt_info,
)
from pegasus_tpu_torch.io.mesh import load_mesh
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.utils.observability import (
    SceneStats,
    completed_scene_ids,
    retry_scene,
    stage_timer,
)


def run_generation(
    config: GenerationConfig,
    env_list: List[Asset],
    obj_list: List[Asset],
    pegasus: Optional[PEGASUS] = None,
    mesh=None,
    device=DEFAULT_DEVICE,
) -> SceneStats:
    out_root = Path(config.dataset_base_path)
    dataset_dir = out_root / config.dataset_name
    if mesh is not None:
        # scene-DP path: mesh-size scene batches, one batched drop per device
        from pegasus_tpu_torch.parallel.generation import run_generation_sharded

        # like the reference, this path leaves gt-info and the NDDS
        # conversion to the caller: finalize_dataset(config)
        return run_generation_sharded(config, env_list, obj_list, mesh=mesh)
    dataset_dir.mkdir(parents=True, exist_ok=True)
    config.save(dataset_dir / "generation_config.json")

    if pegasus is None:
        pegasus = PEGASUS(
            dataset_path=config.dataset_path,
            env_dataset_path=config.env_dataset_path,
            urdf_asset_folder=config.urdf_asset_folder
            or str(Path(config.dataset_path) / "urdf"),
            gs_env_list=env_list,
            gs_object_list=obj_list,
            mode=config.mode,
            camera_trajectory_mode=config.camera_trajectory_mode,
            render_height=config.render_height,
            render_width=config.render_width,
            num_cameras=config.num_cameras,
            simulation_steps=config.simulation_steps,
            num_camera_interpolation_steps=config.num_camera_interpolation_steps,
            dataset_base_path=str(out_root),
            background=config.background,
            seed=config.seed,
            splat_budget=config.splat_budget,
            unit_scale=config.unit_scale,
            frame_chunk=config.frame_chunk,
            compact_readback=config.compact_readback,
            device=device,
        )

    # models once, keyed by real IDs (reference: pegasus.py:510-512)
    models = {
        obj.ID: load_mesh(obj.urdf_obj_path)
        for obj in obj_list
        if Path(obj.urdf_obj_path).exists()
    }
    if models:
        write_models(models, dataset_dir / "models", config.unit_scale)

    stats = SceneStats(path=str(dataset_dir / "generation_stats.jsonl"))
    done = completed_scene_ids(out_root, config.dataset_name) if config.resume else set()

    n_frames = config.num_cameras * config.num_camera_interpolation_steps
    gt_info: dict = {}  # scene id -> its scene_gt_info, from the masks in memory

    def one_scene(scene_id: int) -> None:
        gt_info.pop(scene_id, None)  # a retried scene's earlier records are stale
        t0 = time.perf_counter()
        timers: dict = {}
        with stage_timer(timers, "physics"):
            pegasus.init_bullet(
                env_list=env_list,
                obj_list=obj_list,
                dataset_name=config.dataset_name,
                scene_id=scene_id,
                min_num_objects=config.min_num_objects,
                max_num_objects=config.max_num_objects,
            )
        with stage_timer(timers, "setup"):
            pegasus.init(dataset_name=config.dataset_name, scene_id=scene_id)
            pegasus.init_start_position()
        with stage_timer(timers, "render"):
            pegasus.generate_dataset(
                data_points=config.render_data_points,
                save_bop=True,
                save_video=config.save_video,
            )
        with stage_timer(timers, "finalize"):
            pegasus.save2bop()
        gt_info[scene_id] = pegasus.last_gt_info
        dt = time.perf_counter() - t0
        stats.record(
            scene_id,
            frames=n_frames,
            seconds=dt,
            frames_per_s=n_frames / dt,
            splats=int(pegasus.template.cloud.num_splats),
            n_objects=len(pegasus.bullet_ids),
            env=pegasus.selected_env_name,
            object_ids=pegasus.selected_object_ids,
            **{f"t_{k}": v for k, v in timers.items()},
            # device->host transfer accounting from the render loop (bytes
            # fetched, time blocked on fetches, the hand-off's counters)
            **getattr(pegasus, "last_render_stats", {}),
            # frames whose gt-info came from the masks in memory
            gt_info_frames=len(gt_info[scene_id]),
            # poses applied, splats they wrote, object splats among those
            **pegasus.last_pose_stats,
        )

    for scene_id in range(1, config.num_scenes + 1):
        if scene_id in done:
            continue
        retry_scene(one_scene, scene_id)

    read_back = finalize_dataset(config, gt_info=gt_info)
    print(f"[pegasus-tpu-torch] generation summary: {stats.summary()}, "
          f"gt-info read back from the mask PNGs of {read_back} scene(s)")
    return stats


def finalize_dataset(config: GenerationConfig, gt_info: Optional[dict] = None) -> int:
    """gt-info over the finished scenes and the scene-wise -> image-wise
    NDDS conversion (80 % train, 20 % test), when the config asks for it.
    The sequential path ends with it; after sharded runs the caller does.

    ``gt_info`` maps a scene id to the scene_gt_info that ``PEGASUS``
    computed from the masks in memory (``last_gt_info``), written as it is.
    Every other finished scene whose scene_gt_info.json is missing or older
    than its scene_gt.json gets ``calculate_gt_info``, which reads the mask
    PNGs back.  Returns the number of scenes read back."""
    out_root = Path(config.dataset_base_path)
    dataset_dir = out_root / config.dataset_name
    read_back = []
    if config.convert_scenewise_to_imagewise:
        scene_ids = sorted(
            completed_scene_ids(out_root, config.dataset_name)
        )
        gt_info = gt_info or {}
        for scene_id in scene_ids:
            scene_path = dataset_dir / "train" / f"{scene_id:06d}"
            if scene_id in gt_info:
                write_scene_gt_info(scene_path, gt_info[scene_id])
            elif not _gt_info_is_current(scene_path):
                read_back.append(scene_id)
        calculate_gt_info(out_root, config.dataset_name, read_back)
        n = len(scene_ids)
        split = int(np.round(0.8 * n))
        train_ids = ",".join(str(s) for s in scene_ids[:split])
        test_ids = ",".join(str(s) for s in scene_ids[split:])
        train_dir = dataset_dir / "train"
        if train_ids:
            convert_scenewise_to_imagewise_ndds(
                str(train_dir), str(dataset_dir / "train_ndds"), train_ids
            )
        if test_ids:
            convert_scenewise_to_imagewise_ndds(
                str(train_dir), str(dataset_dir / "test_ndds"), test_ids
            )
    return len(read_back)


def _gt_info_is_current(scene_path: Path) -> bool:
    """scene_gt_info.json is no older than the scene's last file
    (scene_gt.json, written once its masks are on disk).  Equal times are
    current: rewriting a scene takes far longer than a clock tick."""
    info = scene_path / "scene_gt_info.json"
    return info.exists() and (
        info.stat().st_mtime_ns >= (scene_path / "scene_gt.json").stat().st_mtime_ns
    )


def write_targets_bop19(dataset_root, dataset_name: str, out_name: str = "test_targets_bop19.json") -> None:
    """BOP-19 targets file over the generated scenes."""
    import json

    root = Path(dataset_root) / dataset_name
    targets = []
    for scene_dir in sorted((root / "train").iterdir()):
        gt = scene_dir / "scene_gt.json"
        if not gt.exists():
            continue
        scene_id = int(scene_dir.name)
        data = json.loads(gt.read_text())
        for fid, entries in data.items():
            counts: dict = {}
            for e in entries:
                counts[e["obj_id"]] = counts.get(e["obj_id"], 0) + 1
            for obj_id, c in counts.items():
                targets.append(
                    {
                        "im_id": int(fid),
                        "inst_count": c,
                        "obj_id": int(obj_id),
                        "scene_id": scene_id,
                    }
                )
    with open(root / out_name, "w") as f:
        json.dump(targets, f, indent=1)


def main(argv=None) -> None:
    import argparse

    from pegasus_tpu_torch.assets.rosters import full_registry

    parser = argparse.ArgumentParser(description="PEGASUS dataset generation (PyTorch + CUDA port)")
    parser.add_argument("--config", required=True, help="GenerationConfig JSON")
    parser.add_argument("--envs", nargs="*", help="environment class names")
    parser.add_argument("--objects", nargs="*", help="object class names")
    parser.add_argument(
        "--sharded", action="store_true",
        help="scene-data-parallel generation over all visible cards (one lane each)",
    )
    parser.add_argument(
        "--device", default=DEFAULT_DEVICE,
        help="torch device (default: the card; 'cpu' runs the plain torch path)",
    )
    args = parser.parse_args(argv)

    config = GenerationConfig.load(args.config)
    registry = full_registry(config.dataset_path, config.env_dataset_path)
    env_list = (
        [registry.by_class_name(n) for n in args.envs]
        if args.envs
        else registry.environments()
    )
    obj_list = (
        [registry.by_class_name(n) for n in args.objects]
        if args.objects
        else registry.objects()
    )
    mesh = None
    if args.sharded:
        from pegasus_tpu_torch.parallel.mesh import make_mesh

        # --device cpu gives one CPU lane; the default is every visible card
        devices = None if resolve_device(args.device).type == "cuda" else [args.device]
        mesh = make_mesh(axis_names=("scene",), devices=devices)
    run_generation(config, env_list, obj_list, mesh=mesh, device=args.device)


if __name__ == "__main__":
    main()
