"""Launch geometry of the Hopper kernels, checked on the CPU.

``readout_matmul_stats`` (bf16) cuts its row tiles over the flattened B*T rows,
across sample boundaries, and keeps one statistics partial per (row tile,
column tile, sample slot, group); ``gn_act_onepass`` and ``gn_bwd_onepass``
split each sample's rows over the blocks of a cluster, ``gn_bwd_stats`` its
columns. The kernels run only on the card, but what indexes their work is
made in Python and handed to them as it is (the slot table, the rank
splits): it is held here to covering every row or column exactly once, and
to giving the reference's sums when the partials are added in the order the
kernels add them.
"""

import re
from pathlib import Path

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


# -- the GroupNorm backward kernels -------------------------------------------

CSRC = Path(tgg.__file__).parent / "csrc"


@pytest.mark.parametrize("source, name, value", [
    ("gn_bwd_onepass.cu", "kCluster", tgg.ONEPASS_CLUSTER),
    ("gn_bwd_stats.cu", "kCluster", tgg.ONEPASS_CLUSTER),
    ("gn_stats.cu", "GN_STATS_CLUSTER", tgg.STATS_CLUSTER),
    ("gn_bwd_onepass.cu", "kThreads", tgg._BWD_ONEPASS_THREADS),
    ("readout_bwd_fused.cu", "kMaxRanks", trc.BWD_FUSED_MAX_RANKS),
])
def test_wrapper_constants_are_the_kernels(source, name, value):
    """The cluster size the wrappers split rows and columns for, and the
    threads onepass_bwd_smem_bytes counts, are the constants the kernels are
    built with: the engage rule is exactly what a rank allocates; the most F
    tiles one cluster of readout_bwd_fused spans is the one
    bwd_fused_cluster assumes."""
    found = re.findall(rf"(?:constexpr int {name} = |#define {name} )(\d+)\b",
                       (CSRC / source).read_text())
    assert found == [str(value)]


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", [512, 1024, 1280, 2560, 5120, 95008, 300, 17, 8, 1100])
def test_bwd_stats_columns_cover_every_column_once(c, elem):
    """gn_bwd_stats' column split: contiguous slices in rank order, each
    starting on a 16-byte boundary (the kernel's loads), every column once."""
    parts = tgg.bwd_stats_columns(c, elem)
    vec = 16 // elem
    assert len(parts) == tgg.ONEPASS_CLUSTER
    seen = np.zeros(c, dtype=int)
    for rows in parts:
        assert rows.step == 1 and (rows.start % vec == 0 or rows.start == c)
        seen[rows.start:rows.stop] += 1
    assert (seen == 1).all()
    assert [r.start for r in parts] == sorted(r.start for r in parts)
    begin = list(tgg._col_begin(c, elem))
    assert begin == [r.start for r in parts] + [c]


def test_bwd_stats_columns_at_the_train_step_shapes():
    assert [len(r) for r in tgg.bwd_stats_columns(1024, 2)] == [128] * 8
    assert [len(r) for r in tgg.bwd_stats_columns(1280, 2)] == [160] * 8
    assert [len(r) for r in tgg.bwd_stats_columns(95008, 2)] == [11880] * 7 + [11848]
    assert [len(r) for r in tgg.bwd_stats_columns(512, 4)] == [64] * 8


def _bwd_case(b, t, c, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32))
    bias = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    return x, g, scale, bias


def _terms(x, g, scale, bias, mean, inv, groups, act):
    """da, da * xn, dxn, dxn * xn per element (f32), with per-column
    mean and inv taken from per-group ``[B, G]`` values."""
    b, t, c = x.shape
    col = lambda v: v.repeat_interleave(c // groups, dim=1)[:, None, :]  # noqa: E731
    xn = (x - col(mean)) * col(inv)
    da = g * tgg._act_grad(xn * scale + bias, act)
    dxn = da * scale
    return da, da * xn, dxn, dxn * xn


def _emulated_bwd_stats(x, g, scale, bias, stats, groups, act, chunk=4096):
    """gn_bwd_stats' order: per sample, each rank's slice in chunks of
    ``chunk`` columns; a chunk's column sums over T of da and da * xn, times
    scale, go into the rank's group partials chunk after chunk; rank 0 adds
    the ranks' partials in rank order."""
    b, t, c = x.shape
    cg = c // groups
    da, daxn, _, _ = (v.sum(dim=1) for v in _terms(
        x, g, scale, bias, stats[:, 0], stats[:, 1], groups, act))
    dxn, dxnxn = da * scale, daxn * scale
    msums = torch.zeros((b, 2, groups))
    for s in range(b):
        ranks = []
        for cols in tgg.bwd_stats_columns(c, 2):
            blk = torch.zeros((2, groups))
            for c0 in range(cols.start, cols.stop, chunk):
                c1 = min(c0 + chunk, cols.stop)
                for grp in range(c0 // cg, (c1 - 1) // cg + 1):
                    lo, hi = max(grp * cg, c0), min((grp + 1) * cg, c1)
                    blk[0, grp] += dxn[s, lo:hi].sum()
                    blk[1, grp] += dxnxn[s, lo:hi].sum()
            ranks.append(blk)
        acc = torch.zeros((2, groups))
        for blk in ranks:
            acc = acc + blk
        msums[s] = acc / (t * cg)
    return msums, daxn, da


@pytest.mark.parametrize("b, t, c, groups, act", [(2, 6, 300, 4, "gelu"), (2, 9, 1280, 8, "tanh"),
                                                  (1, 4, 2969 * 4, 4, "tanh"),
                                                  (2, 3, 17, 1, "none")])
def test_bwd_stats_partials_in_rank_order_give_the_reference(b, t, c, groups, act):
    x, g, scale, bias = _bwd_case(b, t, c)
    stats = tgg.group_stats_reference(x, groups)
    got = _emulated_bwd_stats(x, g, scale, bias, stats, groups, act)
    want = tgg.gn_bwd_stats_reference(x, scale, bias, g, stats, groups, act)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def _emulated_bwd_onepass(x, g, scale, bias, groups, act, eps=1e-5):
    """gn_bwd_onepass' order: per sample, each rank's rows (cluster_rows)
    summed per column and reduced per group (for dxn and dxn * xn: scale
    times the column sums of da and da * xn); the statistics and the group
    means of dxn, dxn * xn from the ranks' partials added in rank order;
    dscale and dbias per column as the ranks' column sums in rank order."""
    b, t, c = x.shape
    cg, denom = c // groups, t * (c // groups)
    parts = tgg.cluster_rows(t)
    dx = torch.empty_like(x)
    dscale_p, dbias_p = torch.empty((b, c)), torch.empty((b, c))
    for s in range(b):
        xs, gs = x[s:s + 1], g[s:s + 1]
        sq = torch.zeros((2, groups))
        for rows in parts:
            v = xs[0, rows.start:rows.stop].reshape(-1, groups, cg)
            sq = sq + torch.stack([v.sum(dim=(0, 2)), (v * v).sum(dim=(0, 2))])
        mean = sq[0] / denom
        inv = torch.rsqrt(torch.clamp(sq[1] / denom - mean * mean, min=0.0) + eps)
        da, daxn, dxn, _ = _terms(xs, gs, scale, bias, mean[None], inv[None], groups, act)
        m = torch.zeros((2, groups))
        for rows in parts:
            sl = slice(rows.start, rows.stop)
            m = m + torch.stack([(da[0, sl].sum(dim=0) * scale).reshape(groups, cg).sum(dim=1),
                                 (daxn[0, sl].sum(dim=0) * scale).reshape(groups, cg).sum(dim=1)])
        dscale_p[s] = sum(daxn[0, r.start:r.stop].sum(dim=0) for r in parts)
        dbias_p[s] = sum(da[0, r.start:r.stop].sum(dim=0) for r in parts)
        col = lambda v: v.repeat_interleave(cg)  # noqa: E731
        xn = (xs[0] - col(mean)) * col(inv)
        dx[s] = (dxn[0] - col(m[0] / denom) - xn * col(m[1] / denom)) * col(inv)
    return dx, dscale_p.sum(dim=0), dbias_p.sum(dim=0)


@pytest.mark.parametrize("b, t, c, groups, act", [(2, 200, 128, 8, "gelu"), (2, 37, 300, 6, "tanh"),
                                                  (1, 1, 64, 16, "gelu"), (3, 7, 24, 3, "none")])
def test_bwd_onepass_partials_in_rank_order_give_the_reference(b, t, c, groups, act):
    x, g, scale, bias = _bwd_case(b, t, c, seed=1)
    got = _emulated_bwd_onepass(x, g, scale, bias, groups, act)
    want = tgg.group_norm_act_backward_reference(x, scale, bias, g, groups, 1e-5, act)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)
