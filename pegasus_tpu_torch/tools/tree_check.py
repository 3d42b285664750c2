"""Hold two checkouts of the repo against each other on the card: the BOP
trees that ``PEGASUS.generate_dataset`` writes and the compositor kernels'
outputs at the training shape.

    python3 pegasus_tpu_torch/tools/tree_check.py dump ROOT OUT [FRAME_CHUNK]
    python3 pegasus_tpu_torch/tools/tree_check.py compare OUT_A OUT_B

``dump`` runs the package of the checkout at ROOT (a ``git archive`` of
another commit unpacked into a git-ignored directory, or ``.``) in a child
process: it builds the smoke's synthetic dataset (150k-splat environment,
six 10k-splat objects), writes the static (40 frames) and dynamic (8 frames)
640x480 scenes of ``chip_smoke.py``'s phase 5 under OUT/trees, at
FRAME_CHUNK frames per chunk (omitted: the checkout's default, for a
checkout that takes no ``frame_chunk``), and saves the forward kernel's
output and partials and K3's rows at the training shape to OUT/kernels.pt.
``compare`` prints how many files differ byte for byte and whether each
kernel tensor is bitwise equal, and exits 1 if anything differs.  Needs one
CUDA device; run both dumps and the compare in one call, on one card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def _dump(root: str, out: str, frame_chunk: str | None) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    import pegasus_tpu_torch
    from pegasus_tpu_torch.io.png import _load_native
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.composite_vjp import composite_tiles_backward
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import composite_tiles
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS, build_synthetic_dataset

    if not Path(pegasus_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {pegasus_tpu_torch.__file__}, not the package under {root}")
    _load_native()  # before the writer's threads
    dev = torch.device("cuda:0")
    out = Path(out)
    data = build_synthetic_dataset(out / "data", object_names=[n for n, _ in SMOKE_OBJECTS],
                                   env_splats=150_000, obj_splats=10_000)
    kw = {} if frame_chunk is None else {"frame_chunk": int(frame_chunk)}
    for mode, n_cams in (("static", 10), ("dynamic", 2)):
        peg = cs.scene_pegasus(data, out / "trees", mode, mode, n_cams, 4, dev, **kw)
        peg.generate_dataset(cs.MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
    bins = bin_splats(project_gaussians(cs.train_box_cloud(dev), cs.train_camera(dev)),
                      cs.TRAIN_SIZE, cs.TRAIN_SIZE)
    fwd, partials = composite_tiles(bins, cs.TRAIN_SIZE, cs.TRAIN_SIZE, 1, return_partials=True)
    g = torch.randn(fwd.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    bwd = composite_tiles_backward(bins, g, fwd, partials, cs.TRAIN_SIZE, cs.TRAIN_SIZE, 1)
    torch.save({"fwd": fwd.cpu(), "partials": partials.cpu(), "bwd": bwd.cpu()}, out / "kernels.pt")


def compare(a: Path, b: Path) -> bool:
    import torch

    files = sorted(p.relative_to(a / "trees") for p in (a / "trees").rglob("*") if p.is_file())
    if files != sorted(p.relative_to(b / "trees") for p in (b / "trees").rglob("*") if p.is_file()):
        print(f"{a} vs {b}: the trees hold other files", flush=True)
        return False
    differ = [str(f) for f in files if (a / "trees" / f).read_bytes() != (b / "trees" / f).read_bytes()]
    ka, kb = torch.load(a / "kernels.pt"), torch.load(b / "kernels.pt")
    same = {k: torch.equal(ka[k], kb[k]) for k in ka}
    print(f"{a.name} vs {b.name}: {len(files)} files, {len(differ)} differ {differ[:10]}; "
          f"kernel outputs bitwise equal {same}", flush=True)
    return not differ and all(same.values())


def main(argv: list[str]) -> int:
    if argv[0] == "_dump":
        _dump(*argv[1:3], argv[3] if len(argv) > 3 else None)
        return 0
    if argv[0] == "dump":
        return subprocess.run([sys.executable, __file__, "_dump", *argv[1:]]).returncode
    return 0 if compare(Path(argv[1]), Path(argv[2])) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
