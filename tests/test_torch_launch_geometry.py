"""Launch geometry of the two Hopper kernels, checked on the CPU.

``readout_matmul_stats`` (bf16) cuts its row tiles over the flattened B*T rows,
across sample boundaries, and keeps one statistics partial per (row tile,
column tile, sample slot, group); ``gn_act_onepass`` splits each sample's rows
over the blocks of a cluster. The kernels run only on the card, but what
indexes their work is made in Python and handed to them as it is (the slot
table, the rank split): it is held here to covering every row exactly once,
and (for the readout) to giving the reference's statistics when the
partials are added in the finalize's order.
"""

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch.ops import groupnorm_gelu as tgg
from simulgen_vae_tpu_torch.ops import readout_chain as trc


@pytest.mark.parametrize("b, t", [(16, 200), (2, 37), (3, 50), (1, 1), (6, 3)])
def test_slot_table_covers_every_row_once(b, t):
    row_tiles, _, slots = trc.flat_tiles(b, t, 300)
    assert row_tiles == -(-(b * t) // trc.BF16_TILE_M)
    table = trc.slot_table(b, t)
    assert table.dtype == torch.int32 and tuple(table.shape) == (row_tiles, slots, 3)
    seen = np.zeros(b * t, dtype=int)
    for tile in range(row_tiles):
        for slot in range(slots):
            sample, lo, hi = table[tile, slot].tolist()
            assert (lo, hi) == (trc.slot_rows(tile, slot, b, t).start,
                                trc.slot_rows(tile, slot, b, t).stop)
            if sample < 0:
                assert lo == hi
                continue
            assert lo < hi
            # the slot's rows lie in its tile and all belong to its sample
            assert tile * trc.BF16_TILE_M <= lo and hi <= (tile + 1) * trc.BF16_TILE_M
            assert lo // t == sample == (hi - 1) // t
            seen[lo:hi] += 1
    assert (seen == 1).all()
    # every tile's samples fit its slots: a row's slot is found in its own tile
    for row in range(b * t):
        assert (table[row // trc.BF16_TILE_M, :, 0] == row // t).sum() == 1


def test_flat_slots_at_the_shapes_the_card_runs():
    assert trc.flat_tiles(16, 200, 95008) == (25, 372, 2)
    assert trc.flat_tiles(2, 37, 300)[2] == 2          # B bounds the slots
    assert trc.flat_tiles(8, 37, 300)[2] == 5          # ceil(127 / 37) + 1
    assert trc.flat_tiles(3, 50, 1100) == (2, 5, 3)
    assert trc.flat_tiles(1, 1, 16) == (1, 1, 1)
    assert trc.slot_table(16, 200)[1].tolist() == [[0, 128, 200], [1, 200, 256]]


def _emulated_stats(y, num_groups, eps=1e-5, tile_m=trc.BF16_TILE_M, tile_n=trc.BF16_TILE_N):
    """The kernel's partials from a y map, then its finalize's order: per
    sample and group, row tile outer (at the sample's slot), column tile
    inner; f32 throughout."""
    b, t, c = y.shape
    cg = c // num_groups
    yf = y.float().reshape(b * t, c)
    row_tiles, col_tiles, slots = trc.flat_tiles(b, t, c, tile_m, tile_n)
    table = trc.slot_table(b, t, tile_m).tolist()
    part = torch.zeros((row_tiles, col_tiles, slots, 2, num_groups))
    for rt in range(row_tiles):
        for slot in range(slots):
            _, r0, r1 = table[rt][slot]
            for ct in range(col_tiles):
                c0, c1 = ct * tile_n, min((ct + 1) * tile_n, c)
                for g in range(c0 // cg, (c1 - 1) // cg + 1):
                    lo, hi = max(g * cg, c0), min((g + 1) * cg, c1)
                    v = yf[r0:r1, lo:hi]
                    part[rt, ct, slot, 0, g] = v.sum()
                    part[rt, ct, slot, 1, g] = (v * v).sum()
    stats = torch.empty((b, 2, num_groups))
    for s in range(b):
        for g in range(num_groups):
            acc = torch.zeros(2)
            for i in range(row_tiles * slots):  # the slots that name sample s, in order
                rt, slot = divmod(i, slots)
                if table[rt][slot][0] != s:
                    continue
                for ct in range(g * cg // tile_n, ((g + 1) * cg - 1) // tile_n + 1):
                    acc = acc + part[rt, ct, slot, :, g]
            mean = acc[0] / (t * cg)
            var = torch.clamp(acc[1] / (t * cg) - mean * mean, min=0.0)
            stats[s, 0, g], stats[s, 1, g] = mean, torch.rsqrt(var + eps)
    return stats


@pytest.mark.parametrize("b, t, f, c, g", [(2, 37, 64, 300, 6), (3, 50, 64, 1100, 4),
                                           (2, 200, 16, 600, 8), (1, 1, 8, 16, 4)])
def test_partials_in_the_finalize_order_give_the_reference_stats(b, t, f, c, g):
    rng = np.random.default_rng(0)
    h = torch.from_numpy((0.5 * rng.standard_normal((b, t, f))).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, f)) / f ** 0.5).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    y, want = trc.matmul_stats_reference(h, w, bias, torch.tensor(0.8), g)
    got = _emulated_stats(y, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1, 7, 37, 200])
@pytest.mark.parametrize("k", [2, 8])
def test_cluster_rows_cover_every_row_once(t, k):
    parts = tgg.cluster_rows(t, k)
    assert len(parts) == k
    seen = np.zeros(t, dtype=int)
    for rows in parts:
        assert rows.step == 1 and len(rows) <= -(-t // k)
        seen[rows.start:rows.stop] += 1
    assert (seen == 1).all()
    # contiguous, in rank order
    assert [r.start for r in parts] == sorted(r.start for r in parts)


@pytest.mark.parametrize("t", [1, 7, 37, 200])
def test_rank_split_is_the_kernel_argument(t):
    """What the wrapper hands the kernel: each rank's first row, then T, from
    cluster_rows; the kernel stages rows [begin[r], begin[r + 1])."""
    begin = list(tgg._rank_begin(t, tgg.ONEPASS_CLUSTER))
    parts = tgg.cluster_rows(t)
    assert len(begin) == tgg.ONEPASS_CLUSTER + 1 and begin[0] == 0 and begin[-1] == t
    assert [range(begin[r], begin[r + 1]) for r in range(tgg.ONEPASS_CLUSTER)] == parts
    if t == 200:
        assert [len(r) for r in parts] == [25] * 8
