"""``gn_stats``' reduction order, checked on the CPU against the plain version
and the JAX kernel.

The kernel (``ops/csrc/gn_stats.cu``) runs only on the card. What decides its
reduction order is held here: the column split the wrapper hands it
(``stats_col_begin``: ``cluster_columns`` with ``STATS_CLUSTER`` ranks on
``STATS_UNIT_BYTES`` boundaries), its vector width, its chunks (at most
``kMaxVec * kThreads`` vectors) with either row slots (a thread a vector) or
several vectors a thread, each thread's sums of its vectors' columns in their
first group and in the next (a group boundary may fall inside a 16-byte
vector), each group's thread contributions added over a warp, the warps'
shares in warp order, the chunks in order, the ranks in rank order, then the
finalize ``mean = s / n``, ``inv = rsqrt(max(q / n - mean^2, 0) + eps)``.
That model, in f32, is held against ``group_stats_reference`` and against
JAX's ``_tiled_stats`` (Pallas, interpret mode) with the XLA finalize after
it: rtol 1e-5, atol 1e-6 (f32 sums of up to 2.4M terms in another order; the
inputs are N(0, 1), so mean ~ 0 and inv ~ 1).

The constants are parsed from the source. The rule of the kernel's
``dispatch`` (``vector_width``), its chunking (``chunks_of``) and its shared
memory (``smem_bytes``) are copies of ``gn_stats.cu`` that must be kept in
step with it; ``chip_smoke.py`` checks the kernel itself on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simulgen_vae_tpu.ops import groupnorm_gelu as jgg
from simulgen_vae_tpu_torch.ops import groupnorm_gelu as tgg

SOURCE = (Path(tgg.__file__).parent / "csrc" / "gn_stats.cu").read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"(?:constexpr int {name} = |#define {name} )(\d+)\b", SOURCE)
    assert len(found) == 1, name
    return int(found[0])


K_THREADS = _constant("GN_STATS_THREADS")
K_CLUSTER = _constant("GN_STATS_CLUSTER")
K_RING, K_MAX_VEC = _constant("kRing"), _constant("kMaxVec")
K_WARPS = K_THREADS // 32

# (C, G): the decode's and the step's two-phase widths, the readout's
# 11876-wide groups (4 mod 8: group boundaries inside bf16 vectors), a C
# ragged against 128, and 65-wide groups that are no multiple of a vector.
SHAPES = [(1024, 8), (5120, 8), (95008, 8), (1000, 8), (1040, 16)]


def split(c: int, elem: int) -> list[range]:
    """The ranks' columns as the wrapper hands them to the kernel."""
    begin = list(tgg.stats_col_begin(c, elem))
    return [range(begin[r], begin[r + 1]) for r in range(len(begin) - 1)]


def vector_width(c: int, groups: int, elem: int, begins=()) -> int:
    """The kernel's VEC (its dispatch) for a C-wide map of ``elem``-byte
    values (16-byte aligned, as torch allocates): 16-byte loads where C and
    every rank's first column are multiples of a vector and groups are at
    least a vector wide, else one element."""
    vec = 16 // elem
    ok = c % vec == 0 and c // groups >= vec and all(b % vec == 0 for b in begins)
    return vec if ok else 1


def chunks_of(cols: range, vec: int) -> list[tuple[range, int, int]]:
    """A rank's slice in the kernel's chunks of equal width (at most
    kMaxVec * kThreads vectors each), each with its row slots and vectors a
    thread: where a chunk has at most kThreads vectors a thread owns one and
    a row slot (slot s sums rows s, s + slots, ...), else one slot and
    ceil(vectors / kThreads) vectors a thread."""
    vectors = -(-len(cols) // vec)
    n = max(1, -(-vectors // (K_MAX_VEC * K_THREADS)))
    step = -(-vectors // n) * vec
    out = []
    for c0 in range(cols.start, cols.stop, step):
        lanes = -(-min(step, cols.stop - c0) // vec)
        nv = -(-lanes // K_THREADS)
        out.append((range(c0, min(c0 + step, cols.stop)), K_THREADS // lanes if nv == 1 else 1, nv))
    return out


def _chunk_group_sums(xs: torch.Tensor, chunk: range, slots: int, nv: int, vec: int,
                      cg: int) -> dict[int, torch.Tensor]:
    """One chunk of one sample (xs [T, C] f32) in the kernel's order: each
    thread's (sum, sum of squares) of its vectors' parts in each group, a
    warp's lanes added, the warps in warp order. {group: [2]}."""
    lanes = len(chunk) // vec
    x = xs[:, chunk.start:chunk.stop].reshape(xs.shape[0], lanes, vec)
    starts = torch.arange(chunk.start, chunk.stop, vec)
    cut = torch.clamp((starts // cg + 1) * cg - starts, max=vec)
    first = torch.arange(vec)[None, :] < cut[:, None]                        # [lanes, vec]
    # per (row slot, vector): the sums of its rows of each part; thread ids
    per_slot = []
    for slot in range(slots):
        xv = x[slot::slots]
        x0, x1 = xv * first, xv * ~first
        per_slot.append(torch.stack([x0.sum(dim=(0, 2)), (x0 * x0).sum(dim=(0, 2)),
                                     x1.sum(dim=(0, 2)), (x1 * x1).sum(dim=(0, 2))], dim=1))
    sums = torch.cat(per_slot)                                                # [slots * lanes, 4]
    v = torch.arange(lanes).repeat(slots)
    thread = (torch.arange(slots).repeat_interleave(lanes) * lanes + v if nv == 1
              else v % K_THREADS)
    g0 = starts[v] // cg
    out = {}
    for grp in range(chunk.start // cg, (chunk.stop - 1) // cg + 1):
        acc = torch.zeros((K_THREADS, 2))
        acc.index_add_(0, thread[g0 == grp], sums[g0 == grp, :2])
        acc.index_add_(0, thread[g0 == grp - 1], sums[g0 == grp - 1, 2:])
        out[grp] = acc.view(K_WARPS, 32, 2).sum(dim=1).cumsum(dim=0)[-1]
    return out


def emulated_stats(x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's order, in f32: per sample and rank, chunk after chunk,
    :func:`_chunk_group_sums` into the rank's sums; the ranks' sums in rank
    order; the finalize."""
    b, t, c = x.shape
    cg = c // groups
    xf = x.float()
    parts = split(c, x.element_size())
    vec = vector_width(c, groups, x.element_size(), [r.start for r in parts])
    stats = torch.empty((b, 2, groups))
    for s in range(b):
        acc = torch.zeros((2, groups))
        for cols in parts:
            blk = torch.zeros((2, groups))
            for chunk, slots, nv in chunks_of(cols, vec):
                for grp, sums in _chunk_group_sums(xf[s], chunk, slots, nv, vec, cg).items():
                    blk[:, grp] += sums
            acc = acc + blk
        n = float(t * cg)
        mean = acc[0] / n
        stats[s, 0] = mean
        stats[s, 1] = torch.rsqrt(torch.clamp(acc[1] / n - mean * mean, min=0.0) + eps)
    return stats


def _jax_tiled_stats(x: np.ndarray, groups: int, dtype) -> np.ndarray:
    stats, _, _ = jgg._tiled_stats(jnp.asarray(x).astype(dtype), groups, 1e-5)
    return np.asarray(stats)[:, :, :groups]


@pytest.mark.parametrize("t", [1, 200])
@pytest.mark.parametrize("c, groups", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_order_matches_reference_and_jax_tiled_stats(dtype, c, groups, t):
    b = 1 if c * t > 200_000 else 2
    x = np.random.default_rng(c + t).standard_normal((b, t, c)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = emulated_stats(xt, groups).numpy()
    want = tgg.group_stats_reference(xt, groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax_tiled_stats(x, groups, getattr(jnp, dtype)),
                               rtol=1e-5, atol=1e-6)
    # the wrapper's CPU route is the plain version
    np.testing.assert_array_equal(tgg.gn_stats(xt, groups).numpy(), want)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c, groups", SHAPES)
def test_chunks_cover_every_column_once(c, groups, elem):
    """The wrapper's split, then each rank's chunks: every column once, in
    order; each rank's first column on a STATS_UNIT_BYTES boundary; a
    vector's columns in at most two groups; a chunk's vectors fit its
    threads, each thread's rows of its vectors fit its ring."""
    parts = split(c, elem)
    assert len(parts) == K_CLUSTER == tgg.STATS_CLUSTER
    assert parts == tgg.cluster_columns(c, elem, tgg.STATS_CLUSTER, tgg.STATS_UNIT_BYTES)
    vec = vector_width(c, groups, elem, [r.start for r in parts])
    assert vec == 1 or c // groups >= vec
    seen = np.zeros(c, dtype=int)
    ends = []
    for cols in parts:
        assert cols.start * elem % tgg.STATS_UNIT_BYTES == 0 or cols.start == c
        for chunk, slots, nv in chunks_of(cols, vec):
            lanes = -(-len(chunk) // vec)
            assert 1 <= nv <= K_MAX_VEC and lanes <= nv * K_THREADS
            assert slots >= 1 and (nv == 1 or slots == 1) and slots * lanes <= K_THREADS * nv
            assert 2 * nv <= K_RING
            seen[chunk.start:chunk.stop] += 1
            ends.append((chunk.start, chunk.stop))
    assert (seen == 1).all()
    assert ends == sorted(ends)


def test_geometry_at_the_flagship_shapes():
    """C = 95008 in bf16: 16-byte vectors, six ranks of 15872 columns (the
    last 15648) in one chunk of 1984 vectors, four a thread; group
    boundaries inside vectors (11876 = 4 mod 8); in f32 two chunks of 7920
    columns a rank.
    The decode's narrow maps: one chunk a rank with row slots; 65-wide
    groups: 16-byte vectors across groups."""
    assert vector_width(95008, 8, 2) == 8
    parts = split(95008, 2)
    assert [len(r) for r in parts] == [15872] * 5 + [15648]
    assert chunks_of(parts[0], 8) == [(range(0, 15872), 1, 4)]
    assert [len(r) for r in split(95008, 4)] == [15840] * 5 + [15808]
    assert [(len(ch), nv) for ch, _, nv in chunks_of(split(95008, 4)[0], 4)] == [(7920, 4)] * 2
    assert any(g * (95008 // 8) % 8 for g in range(1, 8))
    assert [len(r) for r in split(1024, 2)] == [192] * 5 + [64]
    assert chunks_of(split(1024, 2)[0], 8) == [(range(0, 192), K_THREADS // 24, 1)]
    assert chunks_of(split(5120, 2)[0], 8) == [(range(0, 896), K_THREADS // 112, 1)]
    assert vector_width(1040, 16, 2) == 8 and 1040 // 16 % 8
    assert vector_width(1000, 8, 4) == 4
    assert vector_width(300, 4, 2) == 1       # 300 is no multiple of 8: one element a load
    assert vector_width(64, 16, 2) == 1       # 4-wide groups: narrower than a vector


@pytest.mark.parametrize("groups", [8, 128])
def test_shared_memory_fits_an_sm(groups):
    """A block's shared memory (a copy of the kernel's smem_bytes: the ring,
    the group sums, the warps' shares, the cluster's sums) fits what a block
    may opt into up to G = 128."""
    smem = K_RING * K_THREADS * 16 + 2 * groups * (1 + K_WARPS + K_CLUSTER) * 4
    assert smem <= tgg.ONEPASS_SMEM_LIMIT
    assert K_CLUSTER == tgg.STATS_CLUSTER
