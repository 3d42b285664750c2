"""Copied verbatim from ``pegasus_tpu/assets/in_the_wild_dataset.py``; only the import lines differ.

In-the-wild asset classes (reference: src/dataset/in_the_wild_dataset.py,
missing from the snapshot; authoring pattern documented at
README.md:159-187).

Subclass ``InTheWild`` (or call ``make_wild_asset``) to register a
handheld-scanned object:

    class Bouillon(InTheWild):
        OBJECT_NAME = 'bouillon'
        ID = 201
        TYPE = 'object'
        RECORDING_TYPE = 'spherical'
        ALPHA = 0.3
        DATASET_TYPE = 'wild'
        ARUCO_SIZE = 0.037
"""

from __future__ import annotations

from pegasus_tpu_torch.assets.registry import Asset


class InTheWild(Asset):
    """Base class for in-the-wild scans; subclasses override the class
    constants (README.md:163-187)."""

    OBJECT_NAME = "wild_object"
    ID = 200
    TYPE = "object"
    RECORDING_TYPE = "spherical"
    ALPHA = 0.3
    DATASET_TYPE = "wild"
    ARUCO_SIZE = 0.037

    def __init__(self, dataset_path="."):
        cls = type(self)
        Asset.__init__(
            self,
            OBJECT_NAME=cls.OBJECT_NAME,
            ID=cls.ID,
            TYPE=cls.TYPE,
            RECORDING_TYPE=cls.RECORDING_TYPE,
            ALPHA=cls.ALPHA,
            DATASET_TYPE=cls.DATASET_TYPE,
            ARUCO_SIZE=cls.ARUCO_SIZE,
            dataset_path=str(dataset_path),
        )


class Bouillon(InTheWild):
    """The README's worked example (README.md:161-173)."""

    OBJECT_NAME = "bouillon"
    ID = 201


def make_wild_asset(object_name: str, asset_id: int, **overrides) -> type:
    """Programmatic alternative to subclassing."""
    attrs = {"OBJECT_NAME": object_name, "ID": asset_id}
    attrs.update(overrides)
    return type(object_name.title().replace("_", ""), (InTheWild,), attrs)
