"""Host I/O: BOP writer, PNG, meshes and COLMAP models."""
