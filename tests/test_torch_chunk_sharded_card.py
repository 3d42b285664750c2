"""The frame chunk on the batched and sharded generation, on lanes of the card.

``tests/test_torch_chunk_sharded.py``'s cases on a mesh of four lanes of one
card (``make_mesh(devices=["cuda:0"] * 4)``): the BOP trees of
``run_generation(mesh=)`` at ``frame_chunk`` 1, 3 and 8 byte-identical,
static and dynamic; ``generate_scene_variants`` at ``VARIANT_CHUNK`` 1, 3
and 8 bitwise equal, each variant equal to ``rasterize`` of it alone; the
forward kernel launches, and ``bin_splats`` reads the host, once per chunk.
Needs a CUDA device and ``nvcc``; imports nothing of JAX:

    python -m pytest -m gpu tests/test_torch_chunk_sharded_card.py
"""

import pytest
import torch

from pegasus_tpu_torch.ops import rasterize_cuda
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.parallel.mesh import lane_slices, make_mesh

from test_torch_chunk_sharded import (CHUNKS, N_VARIANTS, assert_variants_equal_alone,  # noqa: F401
                                      chunks_of, differing, root, sharded_trees,
                                      variants_across_chunks)

pytestmark = pytest.mark.gpu

LANES = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def counts():
    return rasterize_cuda.composite_tiles.launches, bin_splats.host_reads


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_sharded_trees_identical_across_frame_chunk_on_card(cuda, root, tmp_path, mode):
    mesh = make_mesh(devices=[cuda] * LANES)
    assert len({lane.stream.cuda_stream for lane in mesh.lanes()}) == LANES
    trees, rises = sharded_trees(root, tmp_path, mode, mesh, counts)
    assert len(trees[1]) > 30
    assert differing(trees) == {c: [] for c in CHUNKS}
    for c, ((launches, reads), scenes) in rises.items():
        want = scenes * chunks_of(6, c)
        assert scenes == 3 and launches == reads == want, (c, launches, reads, want)


def test_variants_equal_across_variant_chunk_on_card(cuda, monkeypatch):
    mesh = make_mesh(devices=[cuda] * LANES)
    results, rises, case = variants_across_chunks(monkeypatch, cuda, mesh, counts)
    for c, res in results.items():
        assert all(torch.equal(a, b) for a, b in zip(results[1], res)), c
        assert res.rgb.device == cuda
    assert_variants_equal_alone(results[8], case)
    cuts = lane_slices(N_VARIANTS, LANES)
    for c, (launches, reads) in rises.items():
        want = sum(chunks_of(cut.stop - cut.start, c) for cut in cuts)
        assert launches == reads == want, (c, launches, reads, want)
