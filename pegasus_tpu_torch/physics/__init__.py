"""URDF files for the synthetic assets (the physics engine is not ported yet)."""
