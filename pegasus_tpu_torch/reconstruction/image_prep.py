"""Copied verbatim from ``pegasus_tpu/reconstruction/image_prep.py``; only the import lines differ.

Image preprocessing for object scans (masking, compositing, renumbering).

Rebuild of the reference's inline ``ImageProcessor``
(reference: src/reconstruction/in_the_wild_object_reconstruction.py:35-112)
and the missing Ortery turntable variant (``data_ortery_preperation.py``,
contract: SURVEY 2.3.3): apply segmentation masks (any tool producing mask
PNGs fits — XMem in the reference, README.md:122-139), composite onto a
background color, optionally downscale, renumber sequentially ('up' scans
start at 1, 'down' scans at 151) and emit an image_list.txt for COLMAP.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


class ImageProcessor:
    def __init__(
        self,
        image_dir,
        mask_dir,
        output_dir,
        start_index: int = 1,
        downscale: float = 1.0,
        background=(0, 0, 0),
        mask_threshold: int = 127,
    ):
        self.image_dir = Path(image_dir)
        self.mask_dir = Path(mask_dir)
        self.output_dir = Path(output_dir)
        self.start_index = start_index
        self.downscale = downscale
        self.background = background
        self.mask_threshold = mask_threshold

    def _images(self):
        exts = (".jpg", ".jpeg", ".png")
        return sorted(
            p for p in self.image_dir.iterdir() if p.suffix.lower() in exts
        )

    def _find_mask(self, image_path: Path) -> Optional[Path]:
        stem = image_path.stem
        for ext in (".png", ".jpg"):
            cand = self.mask_dir / f"{stem}{ext}"
            if cand.exists():
                return cand
        return None

    def process(self, image_list_name: str = "image_list.txt"):
        """Masked/composited/renumbered images + COLMAP image list.
        Returns the list of written file names."""
        from PIL import Image

        self.output_dir.mkdir(parents=True, exist_ok=True)
        written = []
        idx = self.start_index
        for src in self._images():
            img = Image.open(src).convert("RGB")
            mask_path = self._find_mask(src)
            arr = np.asarray(img)
            if mask_path is not None:
                mask = np.asarray(Image.open(mask_path).convert("L"))
                if mask.shape[:2] != arr.shape[:2]:
                    mask = np.asarray(
                        Image.fromarray(mask).resize(
                            (arr.shape[1], arr.shape[0]), Image.NEAREST
                        )
                    )
                m = (mask > self.mask_threshold)[..., None]
                bg = np.asarray(self.background, np.uint8)
                arr = np.where(m, arr, bg[None, None, :])
            out = Image.fromarray(arr.astype(np.uint8))
            if self.downscale != 1.0:
                out = out.resize(
                    (
                        int(out.width * self.downscale),
                        int(out.height * self.downscale),
                    ),
                    Image.LANCZOS,
                )
            name = f"{idx:04d}.png"
            out.save(self.output_dir / name)
            written.append(name)
            idx += 1

        with open(self.output_dir / image_list_name, "w") as f:
            f.write("\n".join(written) + "\n")
        return written


class OrteryImageProcessor(ImageProcessor):
    """Turntable-rig preset: 'up' hemisphere starts at index 1, 'down' at
    151 (the renumbering the missing data_ortery_preperation.py applied,
    SURVEY 2.3.3)."""

    UP_START = 1
    DOWN_START = 151

    def __init__(self, image_dir, mask_dir, output_dir, hemisphere: str = "up",
                 **kwargs):
        start = self.UP_START if hemisphere == "up" else self.DOWN_START
        super().__init__(image_dir, mask_dir, output_dir, start_index=start,
                         **kwargs)
