"""The drop simulation: heightfield ground, batched rigid-body stepper, engine and URDF files."""
