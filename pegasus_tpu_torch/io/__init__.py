"""Host I/O: BOP writer, PNG, meshes and COLMAP models."""

from pegasus_tpu_torch.io.colmap import (
    ColmapCamera,
    ColmapImage,
    ColmapPoint3D,
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
    read_points3d_binary,
    write_cameras_binary,
    write_cameras_text,
    write_images_binary,
    write_images_text,
    write_points3d_binary,
    write_points3d_text,
)
from pegasus_tpu_torch.io.bop_writer import (
    BOPDatasetWriter,
    calculate_gt_info,
    convert_scenewise_to_imagewise_ndds,
    write_models,
)
from pegasus_tpu_torch.io.mesh import TriMesh, load_mesh, load_obj, save_mesh_ply, save_obj
from pegasus_tpu_torch.io.png import write_png
