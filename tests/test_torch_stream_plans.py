"""The launch plans of the port's two streaming kernels, checked without a
card: ``stdp_update.plan`` (synapse tiles, rows per ring stage, ring depth,
volley groups, shared memory) with ``stdp_update.bulk_fill`` (bulk copies or
4-byte ``cp.async``), and ``wta.tile_rows``. A plan must cover every synapse
and every batch row exactly once and never overrun shared memory; the
index arithmetic of the kernel's walk over
(site, tile, chunk) items is restated here, as csrc/stdp_update.cu
documents it, and held to those rules."""
import itertools

import pytest
import torch

from repro_torch.kernels import _build, stdp_update, wta

SHAPES = [(1, 1), (1, 200), (11, 9), (12, 10), (32, 11), (32, 12), (33, 31),
          (2, 5000), (600, 12), (1024, 16), (2048, 128), (16_384, 1), (7, 1025)]


def _item(p, q, tk, tw, t):
    """stdp_item of csrc/stdp_update.cu for tile t of a site: rows
    [i0, i0 + ni), columns [j0, j0 + nj), synapses [s0, s0 + nt)."""
    tj = -(-q // tw)
    it, jt = divmod(t, tj)
    i0, j0 = it * tk, jt * tw
    ni, nj = min(tk, p - i0), min(tw, q - j0)
    return i0, ni, j0, nj, i0 * q + j0, nj if ni == 1 else ni * q


@pytest.mark.parametrize("p,q", SHAPES)
@pytest.mark.parametrize("B", [1, 7, 16, 1000])
def test_stdp_plan_fits_the_block(B, p, q):
    pl = stdp_update.plan(B, p, q)
    assert pl.n == pl.tk * pl.tw and 1 <= pl.n <= stdp_update.MAX_TILE
    assert pl.tw == q or pl.tk == 1  # a tile is one contiguous range
    # one counting thread per synapse of a tile, and the producer warp
    assert pl.threads == -(-pl.n // 32) * 32 + 32 <= stdp_update.MAX_THREADS
    assert pl.tiles == -(-p // pl.tk) * -(-q // pl.tw)
    assert 1 <= pl.rows <= B
    assert 1 <= pl.stages <= stdp_update.MAX_STAGES and pl.group >= 1
    # a volley group (the weights, then group * rows rows of tk + tw bytes)
    # fits a buffer of VOLLEYS bytes per counting thread
    cap = stdp_update.VOLLEYS * (pl.threads - 32)
    assert -(-pl.n // 4) * 4 + pl.group * pl.rows * (pl.tk + pl.tw) <= cap
    # dynamic shared memory beside the static table
    assert pl.smem == stdp_update.smem_bytes(pl.n, pl.rows, pl.stages, pl.threads)
    assert pl.smem + 4 * stdp_update.MAX_TABLE <= _build.MAX_SMEM
    # each stage row starts 16-byte aligned, for bulk copies
    assert (16 * pl.stages) % 16 == 0 and (4 * -(-pl.n // 4) * 4) % 16 == 0


@pytest.mark.parametrize("p,q", SHAPES)
def test_stdp_tiles_cover_the_plane_once(p, q):
    """The tiles of a site are contiguous ranges that cover its plane once,
    and tile thread (il, jl) = divmod(tid, tw) sits at offset tid of its
    tile's range."""
    pl = stdp_update.plan(16, p, q)
    seen = []
    for t in range(pl.tiles):
        i0, ni, j0, nj, s0, nt = _item(p, q, pl.tk, pl.tw, t)
        assert ni >= 1 and nj >= 1 and nt == ni * nj
        for tid in range(pl.n):
            il, jl = divmod(tid, pl.tw)
            if il < ni and jl < nj:
                s = (i0 + il) * q + j0 + jl
                assert s - s0 == tid if pl.tk > 1 or pl.tw == q else s - s0 == jl
                seen.append(s)
    assert sorted(seen) == list(range(p * q))


@pytest.mark.parametrize("p,q", SHAPES)
def test_stdp_bulk_tiles_stay_aligned(p, q):
    """Where the planes allow bulk copies, every tile starts and ends on a
    16-byte boundary of its plane."""
    pl = stdp_update.plan(16, p, q)
    if not (p * q % 4 == 0 and pl.n % 4 == 0 and (pl.tk > 1 or q % 4 == 0)):
        return
    for t in range(pl.tiles):
        *_, s0, nt = _item(p, q, pl.tk, pl.tw, t)
        assert s0 % 4 == 0 and nt % 4 == 0


@pytest.mark.parametrize("C,B,p,q,blocks", [
    (625, 16, 32, 12, 264), (625, 16, 12, 10, 396), (1, 1000, 32, 12, 264),
    (8, 1000, 11, 9, 8), (3, 7, 2048, 128, 5), (2, 9, 2, 5000, 3)])
def test_stdp_walk_covers_every_row_once(C, B, p, q, blocks):
    """The persistent blocks' walk (stdp_chunk) visits every (site, tile,
    batch row) once, each item from one block only: one writer per
    counter."""
    pl = stdp_update.plan(B, p, q)
    items = C * pl.tiles
    blocks = min(blocks, items)
    chunks = -(-B // pl.rows)
    owner, rows_seen = {}, {}
    for blk in range(blocks):
        total = (items - blk + blocks - 1) // blocks * chunks
        for k in range(total):
            item = blk + (k // chunks) * blocks
            ch = k % chunks
            assert item < items
            assert owner.setdefault(item, blk) == blk
            b0 = ch * pl.rows
            nrows = min(pl.rows, B - b0)
            assert nrows >= 1
            rows_seen.setdefault(item, []).extend(range(b0, b0 + nrows))
    assert len(owner) == items
    assert all(r == list(range(B)) for r in rows_seen.values())


def test_stdp_served_plans():
    """The served layers: one tile per site, 8 / 16 rows per stage, two
    stages, a site's whole batch in one volley group, under half the SM's
    shared memory for layer 1."""
    l1, l2 = stdp_update.plan(16, 32, 12), stdp_update.plan(16, 12, 10)
    assert (l1.n, l1.tiles, l1.threads, l1.rows, l1.stages) == (384, 1, 416, 8, 2)
    assert (l2.n, l2.tiles, l2.threads, l2.rows, l2.stages) == (120, 1, 160, 16, 2)
    assert l1.group * l1.rows >= 16 and l2.group * l2.rows >= 16
    assert 2 * (l1.smem + 4 * stdp_update.MAX_TABLE) <= _build.MAX_SMEM


def test_stdp_bulk_fill_choice():
    """Bulk copies for 16-byte aligned planes and strides (the callers'
    (C, 2, B, p, q) draw, or two contiguous tensors), cp.async otherwise."""
    u = torch.rand(5, 2, 7, 32, 12)
    assert stdp_update.bulk_fill(u[:, 0], u[:, 1])
    assert stdp_update.bulk_fill(u[:, 0].contiguous(), u[:, 1].contiguous())
    wide = torch.rand(2, 2, 3, 2, 2500)  # pieces of a row, q % 4 == 0
    assert stdp_update.bulk_fill(wide[:, 0], wide[:, 1])
    wide = torch.rand(2, 2, 3, 2, 2502)  # a row's pieces start off the grid
    assert not stdp_update.bulk_fill(wide[:, 0], wide[:, 1])
    odd = torch.rand(5, 2, 7, 11, 9)  # 396-byte planes
    assert not stdp_update.bulk_fill(odd[:, 0], odd[:, 1])
    flat = torch.rand(5 * 2 * 7 * 32 * 12 + 1)
    shifted = flat[1:].view(5, 2, 7, 32, 12)  # starts 4 bytes in
    assert not stdp_update.bulk_fill(shifted[:, 0], shifted[:, 1])
    assert not stdp_update.bulk_fill(u[:, 0], shifted[:, 1])


@pytest.mark.parametrize("rows,q", itertools.product(
    [1, 3, 4096, 40_000, 40_001, 1_000_003], [1, 3, 12, 13, 33, 128]))
def test_wta_tile_rows(rows, q):
    tile = wta.tile_rows(rows, q, 132)
    assert tile >= 4 and tile % 4 == 0
    assert tile * q * 4 <= wta.MAX_TILE_BYTES
    assert -(-rows // tile) * tile >= rows
    # a full tile is a 16-byte multiple, so its bulk copies are aligned
    assert (tile * q * 4) % 16 == 0


def test_wta_served_shape_fills_the_card():
    tile = wta.tile_rows(64 * 625, 12, 132)
    assert tile == 40 and -(-64 * 625 // tile) >= 2 * 132
    assert wta.group_lanes(12) == 4 and wta.group_lanes(1) == 1
    assert wta.group_lanes(128) == 32


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 12, 13, 33, 127, 128])
def test_wta_group_lanes(q):
    """A power of two, at most a warp, and at most 4 words a lane unless
    the warp is full."""
    g = wta.group_lanes(q)
    assert g & (g - 1) == 0 and 1 <= g <= 32
    assert -(-q // g) <= 4 or g == 32
