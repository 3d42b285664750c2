"""Copied from ``pegasus_tpu/reconstruction/recipes.py``; the import lines differ, and every recipe takes ``device`` (the card by default) for its training and cleaning.

End-to-end reconstruction recipes (offline asset creation, L7).

One function per reference script (reference: src/reconstruction/, SURVEY
2.4).  Every recipe is: preprocess -> COLMAP SfM -> metric scale -> align ->
GS training -> URDF meshing -> GS cleanup, differing in image handling and
pose priors.  COLMAP remains an external executable; GS training runs on
this package's trainer (pegasus_tpu_torch.training: the compositor kernels
on the card).
"""

from __future__ import annotations

from pathlib import Path

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.device import DEFAULT_DEVICE
from pegasus_tpu_torch.reconstruction.alignment import ReconstructionAlignment
from pegasus_tpu_torch.reconstruction.colmap_driver import COLMAPReconstruction
from pegasus_tpu_torch.reconstruction.image_prep import ImageProcessor, OrteryImageProcessor
from pegasus_tpu_torch.reconstruction.urdf_gen import URDFGenerator, gs_cleaning


def _train_gs(data_path, model_path, iterations=30_000, device=DEFAULT_DEVICE, **kwargs):
    from pegasus_tpu_torch.training.trainer import train_gaussian_splatting_wrapper

    return train_gaussian_splatting_wrapper(
        str(data_path), str(model_path), iterations=iterations, device=device, **kwargs
    )


def environment_reconstruction(
    asset: Asset,
    train_iterations: int = 30_000,
    plane_size: float = 2.0,
    run_training: bool = True,
    device=DEFAULT_DEVICE,
) -> None:
    """raw images -> COLMAP -> scale (aruco or const) -> align2plane ->
    GS train -> URDF gen (reference: environment_reconstruction.py:40-92)."""
    base = Path(asset.reconstruction_path)
    reco = COLMAPReconstruction(
        image_path=base / "images", output_path=base
    )
    sparse = reco.run()

    if asset.SCALE is True:
        reco.scale_scene(asset.ARUCO_SIZE)
    elif isinstance(asset.SCALE, (int, float)):
        reco.scale_scene_by_const(float(asset.SCALE))

    align = ReconstructionAlignment(sparse)
    align.align2plane(plane_size=plane_size)
    align.save()

    if run_training:
        _train_gs(base, asset.gs_model_path, iterations=train_iterations, device=device)

    o3d_ply = Path(asset.gs_o3d_point_cloud_path(train_iterations))
    if not o3d_ply.exists():
        raise FileNotFoundError(
            f"no trained cloud at {o3d_ply}; run with run_training=True "
            "or train the asset first"
        )
    gen = URDFGenerator(o3d_ply, object_type="environment")
    gen.generate(asset.urdf_obj_path, asset.urdf_file_path, alpha=asset.ALPHA)


def spherical_object_reconstruction(
    asset: Asset,
    calibration_reconstruction: str | None = None,
    train_iterations: int = 30_000,
    run_training: bool = True,
    device=DEFAULT_DEVICE,
) -> None:
    """Ortery rig: preprocess up+down sets -> COLMAP 'up' locked to the
    calibration board -> register 'down' into the model -> GS train on the
    fused set -> URDF + gs_cleaning
    (reference: spherical_object_reconstruction.py:96-215)."""
    base = Path(asset.dataset_path) / "object" / asset.OBJECT_NAME
    fused_images = base / "fused" / "images"

    lists = []
    for hemi in ("up", "down"):
        proc = OrteryImageProcessor(
            image_dir=base / hemi / "images",
            mask_dir=base / hemi / "masks",
            output_dir=fused_images,
            hemisphere=hemi,
        )
        lists.append(proc.process(image_list_name=f"image_list_{hemi}.txt"))

    work = base / "fused"
    reco = COLMAPReconstruction(image_path=fused_images, output_path=work)
    sparse = reco.run(
        reference_reconstruction=calibration_reconstruction,
        image_list_path=fused_images / "image_list_up.txt",
    )
    reco.registrate_images_into_existing_model(
        database_path=reco.database_path,
        working_dir_images=fused_images,
        image_list_path=fused_images / "image_list_down.txt",
        sparese_model_path=sparse,
        output_path=sparse,
    )
    if asset.SCALE is True:
        reco.scale_scene(asset.ARUCO_SIZE)

    if run_training:
        _train_gs(work, asset.gs_model_path, iterations=train_iterations, device=device)

    gen = URDFGenerator(
        asset.gs_o3d_point_cloud_path(train_iterations), object_type="object"
    )
    gen.generate(asset.urdf_obj_path, asset.urdf_file_path, alpha=asset.ALPHA)
    gs_cleaning(
        asset.gaussian_point_cloud_path(train_iterations),
        t=gen.center_translation,
        R=gen.center_rotation,
        device=device,
    )


def hemispherical_object_reconstruction(
    asset: Asset,
    calibration_reconstruction: str | None = None,
    device=DEFAULT_DEVICE,
    **kwargs,
) -> None:
    """Single-hemisphere variant (reference:
    hemispherical_object_reconstruction.py:44-104)."""
    base = Path(asset.dataset_path) / "object" / asset.OBJECT_NAME
    images = base / "up" / "images"
    work = base / "up"
    reco = COLMAPReconstruction(image_path=images, output_path=work)
    reco.run(reference_reconstruction=calibration_reconstruction)
    if asset.SCALE is True:
        reco.scale_scene(asset.ARUCO_SIZE)
    if kwargs.get("run_training", True):
        _train_gs(work, asset.gs_model_path,
                  iterations=kwargs.get("train_iterations", 30_000), device=device)
    gen = URDFGenerator(
        asset.gs_o3d_point_cloud_path(kwargs.get("train_iterations", 30_000)),
        object_type="object",
    )
    gen.generate(asset.urdf_obj_path, asset.urdf_file_path, alpha=asset.ALPHA)
    gs_cleaning(
        asset.gaussian_point_cloud_path(kwargs.get("train_iterations", 30_000)),
        t=gen.center_translation, R=gen.center_rotation, device=device,
    )


def in_the_wild_object_reconstruction(
    asset: Asset,
    device=DEFAULT_DEVICE,
    **kwargs,
) -> None:
    """Handheld scans with external (e.g. XMem) masks: mask+renumber both
    hemispheres, COLMAP 'up', aruco scale, align, register 'down', train,
    URDF + cleaning (reference: in_the_wild_object_reconstruction.py:35-219).
    Masks come from any segmenter producing PNGs (XMem is offline-only,
    SURVEY 2.2)."""
    base = Path(asset.dataset_path) / "object" / asset.OBJECT_NAME
    fused_images = base / "fused" / "images"
    for hemi, start in (("up", 1), ("down", 151)):
        hemi_dir = base / hemi
        if not hemi_dir.exists():
            continue
        ImageProcessor(
            image_dir=hemi_dir / "images",
            mask_dir=hemi_dir / "masks",
            output_dir=fused_images,
            start_index=start,
        ).process(image_list_name=f"image_list_{hemi}.txt")

    work = base / "fused"
    reco = COLMAPReconstruction(image_path=fused_images, output_path=work)
    sparse = reco.run(image_list_path=fused_images / "image_list_up.txt")
    if asset.SCALE is True:
        reco.scale_scene(asset.ARUCO_SIZE)
    align = ReconstructionAlignment(sparse)
    align.align2plane()
    align.save()
    down_list = fused_images / "image_list_down.txt"
    if down_list.exists():
        reco.registrate_images_into_existing_model(
            database_path=reco.database_path,
            working_dir_images=fused_images,
            image_list_path=down_list,
            sparese_model_path=sparse,
            output_path=sparse,
        )
    it = kwargs.get("train_iterations", 30_000)
    if kwargs.get("run_training", True):
        _train_gs(work, asset.gs_model_path, iterations=it, device=device)
    gen = URDFGenerator(asset.gs_o3d_point_cloud_path(it), object_type="object")
    gen.generate(asset.urdf_obj_path, asset.urdf_file_path, alpha=asset.ALPHA)
    gs_cleaning(
        asset.gaussian_point_cloud_path(it),
        t=gen.center_translation, R=gen.center_rotation, device=device,
    )


def calibration_reconstruction(asset: Asset) -> Path:
    """Build the reusable calibration-board reconstruction used as a pose
    prior for turntable scans (reference: calibration_reconstruction.py,
    spherical_calibration_reconstruction.py)."""
    base = Path(asset.reconstruction_path)
    reco = COLMAPReconstruction(image_path=base / "images", output_path=base)
    sparse = reco.run()
    if asset.SCALE is True:
        reco.scale_scene(asset.ARUCO_SIZE)
    return sparse
