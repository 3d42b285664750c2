"""Scene composition, camera paths, recorded trajectories and preview video."""
