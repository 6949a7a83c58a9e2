"""The row split's table of slabs (``codeps_torch.parallel.spatial.
slab_rows``), a pure function of (height, ranks, rank): a height's blocks
of 32 rows dealt out over the ranks as evenly as whole blocks allow, the
larger slabs first; with fewer blocks than ranks the last ranks' slabs
are empty. No process group, no JAX."""

import pytest

from codeps_torch.parallel import spatial

BLOCK = spatial.ROW_ALIGN


def _table(height, ranks):
    return [spatial.slab_rows(height, ranks, r) for r in range(ranks)]


@pytest.mark.parametrize("height, ranks", [(384, 8), (384, 5), (512, 3),
                                           (96, 2), (64, 2)])
def test_slabs_cover_the_height_in_whole_blocks(height, ranks):
    table = _table(height, ranks)
    # in order, each slab starting where the last ended, to the bottom row
    assert table[0][0] == 0
    for (first, size), (next_first, _) in zip(table, table[1:]):
        assert first + size == next_first
    assert table[-1][0] + table[-1][1] == height
    sizes = [size for _, size in table]
    assert all(size >= BLOCK and size % BLOCK == 0 for size in sizes)
    assert max(sizes) - min(sizes) <= BLOCK
    # the larger slabs first
    assert sizes == sorted(sizes, reverse=True)
    # whole rows on every rank at every level down to stride 32, and at
    # every loss scale height // 2**s
    for stride in (1, 2, 4, 8, 16, 32):
        assert all(size % stride == 0 and first % stride == 0
                   for first, size in table)


def test_published_heights():
    # 512 source rows on 3 ranks: 6 / 5 / 5 blocks; 384 target rows on an
    # 8-card node: 2 blocks on four ranks, 1 on the others
    assert [size // BLOCK for _, size in _table(512, 3)] == [6, 5, 5]
    assert [size // BLOCK for _, size in _table(384, 8)] == [2] * 4 + [1] * 4
    assert [size // BLOCK for _, size in _table(384, 3)] == [4, 4, 4]
    assert _table(96, 2) == [(0, 64), (64, 32)]
    # one rank holds the whole image
    assert _table(384, 1) == [(0, 384)]


@pytest.mark.parametrize("height, ranks", [(32, 2), (32, 8), (96, 4),
                                           (384, 13), (384, 16)])
def test_fewer_blocks_than_ranks_leave_the_last_slabs_empty(height, ranks):
    table = _table(height, ranks)
    blocks = height // BLOCK
    # one block for each of the first ranks, an empty slab at the image's
    # bottom for the rest
    assert table[:blocks] == [(r * BLOCK, BLOCK) for r in range(blocks)]
    assert table[blocks:] == [(height, 0)] * (ranks - blocks)
    # in order, each slab starting where the last ended, to the bottom row
    assert table[0][0] == 0
    for (first, size), (next_first, _) in zip(table, table[1:]):
        assert first + size == next_first
    assert sum(size for _, size in table) == height


@pytest.mark.parametrize("height, ranks", [(80, 2), (100, 1)])
def test_refused_heights_name_height_and_ranks(height, ranks):
    # not a multiple of 32 rows
    with pytest.raises(ValueError, match=f"{height} rows does not split "
                                         f"over {ranks} ranks"):
        spatial.slab_rows(height, ranks, 0)
