"""The tile classes of the bfloat16 training kernels against their masks.

The kernels skip a (64-query, 64-key) tile classed EMPTY and apply no mask
to one classed FULL, so the classification must be conservative: an EMPTY
tile holds no allowed pair, a FULL tile only allowed pairs (rows past T and
keys past S count as not allowed). Causal tiles are classed from their
indices (``flash_tile_classes``, mirrored by ``CausalMask::tile_class``);
COD tiles from per-tile summaries (``pard_tile_classes``, the table the
kernels read). Torch only; layouts from the port's ``pack_batch``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cod import CodConfig, pack_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pard_attention as pa

TILE = fa.TILE


def _tiles_of(allowed):
    """(any, all) allowed pair per tile of a boolean [..., T, S] mask,
    padded with False past T and S."""
    t, s = allowed.shape[-2:]
    nq, nk = -(-t // TILE), -(-s // TILE)
    pad = torch.nn.functional.pad(allowed, (0, nk * TILE - s, 0, nq * TILE - t))
    tiles = pad.unflatten(-1, (nk, TILE)).unflatten(-3, (nq, TILE))
    tiles = tiles.transpose(-3, -2)                  # [..., nq, nk, TILE, TILE]
    return tiles.flatten(-2).any(-1), tiles.flatten(-2).all(-1)


def _assert_conservative(cls, allowed):
    some, every = _tiles_of(allowed)
    assert cls.shape == some.shape and cls.dtype == torch.uint8
    assert set(cls.unique().tolist()) <= {fa.EMPTY, fa.PARTIAL, fa.FULL}
    assert not some[cls == fa.EMPTY].any(), "an EMPTY tile holds an allowed pair"
    assert every[cls == fa.FULL].all(), "a FULL tile holds a masked pair"
    return some, every


@pytest.mark.parametrize("t,s,window", [
    (1, 1, 0),                 # one row, one key
    (64, 64, 0),               # one whole tile: the diagonal is partial
    (65, 65, 0),               # one row off the tile
    (1023, 1023, 0),           # the AR training length
    (1024, 1024, 0),
    (300, 300, 40),            # window smaller than a tile
    (600, 600, 128),           # window of two tiles
    (300, 128, 40),            # S < T: rows past S + window - 1 see nothing
    (200, 77, 0),              # S < T off the tile
    (129, 129, 64),            # window of exactly one tile
])
def test_flash_tile_classes_are_conservative(t, s, window):
    cls = fa.flash_tile_classes(t, s, window=window)
    allowed = fa.flash_allowed(t, s, window=window)
    some, every = _assert_conservative(cls, allowed)
    # the index rule is exact away from the ragged edge: a tile within T and
    # S is FULL iff every pair is allowed, EMPTY iff none is
    nq, nk = cls.shape
    inside = ((torch.arange(nq) + 1) * TILE <= t)[:, None] & \
        ((torch.arange(nk) + 1) * TILE <= s)[None, :]
    assert torch.equal((cls == fa.FULL) & inside, every & inside)
    assert torch.equal((cls == fa.EMPTY) & inside, ~some & inside)


def test_flash_tile_classes_at_the_training_shape():
    """AR training, T = 1024: of 256 tiles per (row, head), the 16 on the
    diagonal are partial and the 120 below it full."""
    cls = fa.flash_tile_classes(1024, 1024)
    assert int((cls == fa.PARTIAL).sum()) == 16
    assert int((cls == fa.FULL).sum()) == 120
    assert int((cls == fa.EMPTY).sum()) == 120


def test_flash_tile_classes_non_causal():
    cls = fa.flash_tile_classes(130, 200, causal=False)
    _assert_conservative(cls, fa.flash_allowed(130, 200, causal=False))
    assert int((cls == fa.EMPTY).sum()) == 0
    assert int((cls == fa.FULL).sum()) == 6      # 2 whole query tiles x 3 whole key tiles


def _cod(seed, b, n, k, extra=0):
    rng = np.random.default_rng(seed)
    packed = pack_batch(rng.integers(0, 1000, (b, n)), CodConfig(k, 0.7, 0.2),
                        1000, seed=seed)
    seg = torch.from_numpy(packed["segment"]).to(torch.int32)
    base = torch.from_numpy(packed["base"]).to(torch.int32)
    pad = torch.zeros(b, extra, dtype=torch.int32)
    return torch.cat([seg, pad], 1), torch.cat([base, pad], 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,n,k,extra", [
    (2, 200, 8, 0),            # K = 8, B > 1
    (3, 130, 4, 21),           # K = 4, a padding tail off the tile
    (2, 96, 8, 64),            # a whole tile of padding
    (1, 48, 4, 5),             # one partial tile
    (2, 512, 8, 3),            # the training length
])
def test_pard_tile_classes_are_conservative(seed, b, n, k, extra):
    seg, base = _cod(seed, b, n, k, extra)
    cls = pa.pard_tile_classes(seg, base)
    allowed = pa.pard_mask(seg, base, seg, base)
    some, every = _assert_conservative(cls, allowed)
    # a tile with a padding token is never full
    live = torch.nn.functional.pad(seg > 0, (0, cls.shape[-1] * TILE - seg.shape[1]))
    live = live.unflatten(-1, (cls.shape[-1], TILE))
    all_live, dead = live.all(-1), ~live.any(-1)
    full = cls == fa.FULL
    assert not (full & ~all_live[:, :, None]).any()
    assert not (full & ~all_live[:, None, :]).any()
    # a tile of padding only is empty both ways (no copy, no math)
    assert (cls.transpose(1, 2)[dead] == fa.EMPTY).all()
    assert (cls[dead] == fa.EMPTY).all()
    if extra >= TILE:
        assert dead.any()


def test_pard_tile_classes_at_the_training_layout():
    """The COD layout that chip_smoke.py times (B=4, N=512 packed at K=8,
    r=0.7, r_min=0.2, T=1726): at most 1,361 of the 2,916 tiles visited
    (here every visited tile holds an allowed pair: the per-part summaries
    leave no tile that straddles a segment boundary visited for nothing),
    and every wholly allowed tile found FULL."""
    rng = np.random.default_rng(13)
    packed = pack_batch(rng.integers(0, 128000, (4, 512)),
                        CodConfig(8, 0.7, 0.2), 128256,
                        seed=int(rng.integers(1 << 30)))
    seg = torch.from_numpy(packed["segment"]).to(torch.int32)
    base = torch.from_numpy(packed["base"]).to(torch.int32)
    assert seg.shape == (4, 1726)
    cls = pa.pard_tile_classes(seg, base)
    some, every = _assert_conservative(cls, pa.pard_mask(seg, base, seg, base))
    assert cls.numel() == 2916
    assert int((cls != fa.EMPTY).sum()) <= 1361
    assert int((cls == fa.FULL).sum()) == int(every.sum()) > 0
    assert int(some.sum()) == int((cls != fa.EMPTY).sum())


def test_pard_tile_classes_keep_the_input_unchanged():
    seg, base = _cod(5, 2, 100, 8, 7)
    before = (seg.clone(), base.clone())
    pa.pard_tile_classes(seg, base)
    assert torch.equal(seg, before[0]) and torch.equal(base, before[1])


def test_pard_mask_info_makes_its_table_once():
    """A batch's PardMaskInfo owns the class table of its own layout: made
    at the first read, then shared by every layer."""
    seg, base = _cod(6, 2, 100, 8, 7)
    info = pa.PardMaskInfo(seg, base)
    assert "tiles" not in vars(info)            # nothing made before a read
    tiles = info.tiles
    assert torch.equal(tiles, pa.pard_tile_classes(seg, base))
    assert info.tiles is tiles
