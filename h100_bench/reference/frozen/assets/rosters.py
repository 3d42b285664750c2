"""Frozen copy of pegasus_tpu_torch/assets/rosters.py at commit 7a69f88, cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/assets/rosters.py``; only the import lines differ.

Compat asset rosters: class-per-asset shims over the Asset dataclass.

The reference wires its scenes from per-asset classes in the (missing)
``src/dataset`` package — 21 YCB-V objects, 30 CupNoodles (IDs 101-130) and
the environment set (rosters recovered at pegasus.py:411-473,
environment_reconstruction.py:24-36, README.md:201-207; YCB-V IDs are the
original YCB-V ids per README.md:203).  Folder names follow the snake_case
convention observed in the shipped physics fixture
(src/engine/simulation_steps.json: 'asphalt', 'cup_noodles_04').
"""

from __future__ import annotations

from reference.frozen.assets.registry import Asset


def _asset_class(class_name, object_name, asset_id, asset_type="object", **defaults):
    def __init__(self, dataset_path="."):
        Asset.__init__(
            self,
            OBJECT_NAME=object_name,
            ID=asset_id,
            TYPE=asset_type,
            dataset_path=str(dataset_path),
            **defaults,
        )

    return type(class_name, (Asset,), {"__init__": __init__})


# -- PEGASET: the 21 YCB-V objects with original YCB-V ids ---------------------
_YCB = [
    ("MaxwellCoffee", "maxwell_coffee", 1),   # 002_master_chef_can counterpart
    ("CrackerBox", "cracker_box", 2),
    ("DominoSugar", "domino_sugar", 3),
    ("TomatoSoup", "tomato_soup", 4),
    ("YellowMustard", "yellow_mustard", 5),
    ("Tuna", "tuna", 6),
    ("ChocoJello", "choco_jello", 7),
    ("StrawberryJello", "strawberry_jello", 8),
    ("Spam", "spam", 9),
    ("Banana", "banana", 10),
    ("Pitcher", "pitcher", 11),
    ("SoftScrub", "soft_scrub", 12),
    ("RedBowl", "red_bowl", 13),
    ("RedCup", "red_cup", 14),
    ("Drill", "drill", 15),
    ("WoodenBlock", "wooden_block", 16),
    ("Scissors", "scissors", 17),
    ("Pen", "pen", 18),
    ("SmallClamp", "small_clamp", 19),
    ("LargeClamp", "large_clamp", 20),
    ("FoamBrick", "foam_brick", 21),
]

YCB_CLASSES = {}
for _cls, _name, _id in _YCB:
    YCB_CLASSES[_cls] = _asset_class(_cls, _name, _id, DATASET_TYPE="ycb")

# -- Ramen dataset: 30 cup noodles, ids 101-130 ---------------------------------
CUP_NOODLE_CLASSES = {}
for _i in range(1, 31):
    _cls = f"CupNoodle{_i:02d}"
    CUP_NOODLE_CLASSES[_cls] = _asset_class(
        _cls, f"cup_noodles_{_i:02d}", 100 + _i, DATASET_TYPE="cup_noodles"
    )

# -- environments ----------------------------------------------------------------
_ENVS = [
    ("MannholeCover", "mannhole_cover", 1001),
    ("Cobblestone", "cobblestone", 1002),
    ("Asphalt", "asphalt", 1003),
    ("Asphalt2", "asphalt2", 1004),
    ("Tiles", "tiles", 1005),
    ("Tiles2", "tiles2", 1006),
    ("Grass", "grass", 1007),
    ("Wood", "wood", 1008),
    ("PlainTableSetup", "plain_table_setup", 1009),
    ("Garden", "garden", 1010),
    ("Counter", "counter", 1011),
    ("Desk", "desk", 1012),
]
ENV_CLASSES = {}
for _cls, _name, _id in _ENVS:
    ENV_CLASSES[_cls] = _asset_class(
        _cls, _name, _id, asset_type="environment", DATASET_TYPE="environment"
    )

# calibration boards (calibration_reconstruction.py:4,17-19)
CALIBRATION_CLASSES = {}
for _cls, _name, _id in [
    ("CalibrationBoard", "calibration_board", 2001),
    ("WoodenCalibrationBoard", "wooden_calibration_board", 2002),
    ("SecurityCalibrationBoard", "security_calibration_board", 2003),
]:
    CALIBRATION_CLASSES[_cls] = _asset_class(
        _cls, _name, _id, asset_type="environment", DATASET_TYPE="calibration"
    )


