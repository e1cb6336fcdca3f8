"""The dy-free readout backward (``readout_bwd_fused``) on the CPU.

The port's plain version ``bwd_fused_reference`` (what ``readout_bwd_fused``
takes for CPU tensors) against the JAX op's gradients with the JAX package's
fused backward forced (``SIMULGEN_READOUT_BWD=fused``, its Pallas kernel
``_bwd_fused_dw_kernel`` in interpret mode) at a geometry where the JAX rule
engages; the port's two backward flavors against each other; the ``bwd``
argument; the engage rule. Inputs come from numpy seeds. The port keeps the
readout kernel as ``[C, F]``; JAX's is ``[F, C]``.

The bf16 kernel (``ops/csrc/readout_bwd_fused.cu``) runs only on the card.
What decides its partition and its order of summation is modelled here, as
``tests/test_torch_gn_stats.py`` models ``gn_stats``: the ranks' slices of each
dy stage and each thread's rows and vector in them (every element once, each
inside its rank's bulk-copied slice), the slab plan and the units of work a
persistent cluster walks (every loop step once), the shared-memory layout
(every ring depth fits), and the sums: per thread an f32 sum of the f32 dy
per column and an f64 sum of the f32 partial of dy * (y - bias) over each
vector, then per tile the row lanes in order and the warps in order, then the
(slab, rank) partials in order. The model in f32 is held against
``bwd_fused_reference`` and against the JAX op's fused backward (Pallas,
interpret mode; at C = 300 the JAX rule does not engage it and the JAX op
materializes dy): rtol 1e-5, atol 1e-6. The constants are parsed from the
source; the plan's cost model and the layout are copies of the source that
must be kept in step with it; ``chip_smoke.py`` checks the kernel on the card
and its plan against ``bwd_fused_cluster``.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulgen_vae_tpu.ops import readout_chain as jrc
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops import readout_chain as trc

LOSSES = ["MSE", "MAE", "Huber", "smoothL1"]
JAX_GEOM = (3, 5, 16, 1100)          # the JAX rule engages its fused backward here
FLAVOR_GEOMS = [(3, 5, 16, 1100, 4), (2, 37, 64, 300, 6), (4, 12, 128, 640, 8)]


def _case(b, t, f, c, seed=0, inv=0.8):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        h=f32(rng.standard_normal((b, t, f)) * 0.3),
        kernel=f32(rng.standard_normal((f, c)) * 0.1),      # JAX layout [F, C]
        bias=f32(rng.standard_normal(c) * 0.1),
        scale=f32(1.0 + 0.1 * rng.standard_normal(c)),
        norm_bias=f32(rng.standard_normal(c) * 0.1),
        x=f32(rng.standard_normal((b, t, c)) * 0.5),
        inv=np.float32(inv))


def _torch_args(case, dtype=torch.float32):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()
         if k not in ("inv", "kernel")}
    t["kernel"] = torch.from_numpy(np.ascontiguousarray(case["kernel"].T))  # [C, F]
    t["inv"] = torch.tensor(float(case["inv"]))
    t["h"], t["x"] = t["h"].to(dtype), t["x"].to(dtype)
    for k in ("h", "kernel", "bias", "scale", "norm_bias", "inv"):
        t[k].requires_grad_()
    return t


def _torch_grads(case, groups, lossfun, bwd, dtype=torch.float32):
    t = _torch_args(case, dtype)
    l, m = trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"],
                                  t["x"], t["inv"], groups, 1e-5, lossfun, bwd=bwd)
    (l + 0.3 * m).backward()
    return [t["h"].grad.float(), t["kernel"].grad.t(), t["bias"].grad, t["scale"].grad,
            t["norm_bias"].grad, t["inv"].grad]


NAMES = ["dh", "dW", "dbias", "dscale", "dnorm_bias", "dinv_sigma"]


@pytest.mark.parametrize("inv", [1.0, 1.3])
@pytest.mark.parametrize("lossfun", LOSSES)
def test_fused_backward_matches_jax_fused_backward(monkeypatch, lossfun, inv):
    """f32, rtol 5e-4 with atol 1e-6 (the JAX package's own bound for this op:
    sums over T x C in another order)."""
    monkeypatch.setenv("SIMULGEN_READOUT_BWD", "fused")
    b, t, f, c = JAX_GEOM
    assert jrc.bwd_flavor(b, t, f, c) == "fused"
    case = _case(b, t, f, c, seed=1, inv=inv)
    h, kernel, bias, scale, nb, x, inv_ = (jnp.asarray(case[k]) for k in
                                           ("h", "kernel", "bias", "scale", "norm_bias",
                                            "x", "inv"))

    def loss(h_, k_, b_, s_, nb_, i_):
        l, m = jrc.readout_chain_loss(h_, k_, b_, s_, nb_, x, i_, 4, 1e-5, lossfun)
        return l + 0.3 * m

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(h, kernel, bias, scale, nb, inv_)
    got = _torch_grads(case, 4, lossfun, "fused")
    for name, a, b_ in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=5e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("geom", FLAVOR_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_backward_flavors_agree_f32(geom):
    """rtol 2e-3 (JAX's own bound between its two flavors) with atol 1e-6."""
    b, t, f, c, g = geom
    case = _case(b, t, f, c, seed=2, inv=1.2)
    fused = _torch_grads(case, g, "Huber", "fused")
    mat = _torch_grads(case, g, "Huber", "materialize")
    for name, a, b_ in zip(NAMES, fused, mat):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=2e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("geom", FLAVOR_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_backward_flavors_agree_bf16(geom):
    """bf16 maps: the fused flavor rounds dy once and keeps f32 dW and dh, the
    materializing one also rounds the products' outputs: rel-L2 2e-2."""
    b, t, f, c, g = geom
    case = _case(b, t, f, c, seed=3, inv=0.9)
    fused = _torch_grads(case, g, "MSE", "fused", torch.bfloat16)
    mat = _torch_grads(case, g, "MSE", "materialize", torch.bfloat16)
    for name, a, b_ in zip(NAMES, fused, mat):
        rel = float(torch.linalg.vector_norm(a - b_) / torch.linalg.vector_norm(b_))
        assert rel <= 2e-2, f"{name}: rel-L2 {rel:.3g}"


def test_plain_version_rounds_dy_before_the_products_only():
    """dW and dh use dy rounded to the map's dtype; dbias and dinv the f32 dy."""
    b, t, f, c, g = 2, 6, 16, 200, 8
    case = _case(b, t, f, c, seed=4)
    a = _torch_args(case, torch.bfloat16)
    with torch.no_grad():
        w = a["kernel"].bfloat16()
        y, stats = trc.matmul_stats_reference(a["h"], w, a["bias"], a["inv"], g)
        gvec = torch.tensor([1.0, 0.3, float(a["inv"])])
        n_elem = float(b * t * c)
        chain = (a["x"], a["scale"], a["norm_bias"])
        msums = trc.bwd_stats_reference(y, *chain, stats, gvec, n_elem, g)[0]
        dw, dh, dbias, dinv = trc.bwd_fused_reference(y, *chain, a["bias"], a["h"], w, stats,
                                                      msums, gvec, n_elem, g)
        dy, dbias_p, dinv_p = trc.bwd_dy_reference(y, *chain, a["bias"], stats, msums, gvec,
                                                   n_elem, g)
    assert dw.dtype == dh.dtype == dbias.dtype == dinv.dtype == torch.float32
    assert tuple(dw.shape) == (c, f) and tuple(dh.shape) == (b, t, f) and dinv.dim() == 0
    dy2 = dy.float().reshape(b * t, c)                       # the rounded dy
    np.testing.assert_allclose(dw.numpy(), (dy2.t() @ a["h"].detach().float().reshape(-1, f)).numpy(),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(dh.reshape(-1, f).numpy(), (dy2 @ w.float()).numpy(),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(dbias.numpy(), dbias_p.sum(0).numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(float(dinv), float(dinv_p.sum()), rtol=1e-4)


@pytest.mark.parametrize("bwd, fused_calls, dy_calls",
                         [("fused", 1, 0), ("materialize", 0, 1)])
def test_bwd_argument_selects_the_flavor(monkeypatch, bwd, fused_calls, dy_calls):
    """On the CPU the wrappers take their plain versions: count those calls."""
    calls = {"fused": 0, "dy": 0}
    real_fused, real_dy = trc.bwd_fused_reference, trc.bwd_dy_reference
    monkeypatch.setattr(trc, "bwd_fused_reference",
                        lambda *a, **k: calls.__setitem__("fused", calls["fused"] + 1)
                        or real_fused(*a, **k))
    monkeypatch.setattr(trc, "bwd_dy_reference",
                        lambda *a, **k: calls.__setitem__("dy", calls["dy"] + 1)
                        or real_dy(*a, **k))
    trc.reset_launch_counts()
    _torch_grads(_case(2, 6, 64, 200, seed=5), 8, "MSE", bwd)
    assert (calls["fused"], calls["dy"]) == (fused_calls, dy_calls)
    assert all(n == 0 for n in trc.LAUNCHES.values())       # no kernel on the CPU


def test_auto_follows_the_engage_rule_and_unknown_values_raise(monkeypatch):
    seen = []
    real = trc.bwd_flavor
    monkeypatch.setattr(trc, "bwd_flavor", lambda *g: seen.append(g) or real(*g))
    _torch_grads(_case(2, 6, 64, 200, seed=6), 8, "MSE", "auto")
    assert seen == [(2, 6, 64, 200)]
    t = _torch_args(_case(2, 6, 64, 200))
    with pytest.raises(ValueError, match="bwd must be"):
        trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"],
                               t["x"], t["inv"], 8, bwd="dy_free")


def test_engage_rule_names_both_flavors():
    """The rule's answers are the faster segment of the card's table (its
    docstring): the dy-free backward between the tiny maps and C = 95008."""
    geoms = [(16, 200, 1024, 95008), (16, 200, 128, 95008), (16, 200, 128, 5120),
             (4, 200, 128, 5120), (2, 37, 64, 300), (3, 50, 64, 1100), (3, 5, 16, 1100)]
    answers = [trc.bwd_flavor(*g) for g in geoms]
    assert set(answers) == {"fused", "materialize"}
    assert answers[0] == "materialize"          # the flagship: as the JAX rule answers
    assert trc.bwd_flavor(3, 5, 16, 1100) == "materialize"   # F is no multiple of 64
    assert trc.bwd_flavor(3, 50, 64, 1100) == "materialize"  # measured: launches set the time
    assert trc.bwd_flavor(16, 200, 128, 5120) == "fused"
    assert trc.bwd_flavor(4, 200, 128, 5120) == "fused"


def test_other_devices_raise_and_nothing_falls_back():
    t = {k: v.detach().to("meta") for k, v in _torch_args(_case(2, 6, 64, 200)).items()}
    stats = torch.empty((2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trc.readout_bwd_fused(t["x"], t["x"], t["scale"], t["norm_bias"], t["bias"], t["h"],
                              t["kernel"], stats, stats, t["bias"], 1.0, 8)
    with pytest.raises(ValueError, match="no readout kernel"):
        trc.readout_chain_loss(t["h"], t["kernel"], t["bias"], t["scale"], t["norm_bias"],
                               t["x"], t["inv"], 8, bwd="fused")
    assert trc.LAUNCHES["readout_bwd_fused"] == 0


def test_build_list_holds_thirteen_kernels_with_their_sources():
    assert len(_build.KERNELS) == len(set(_build.KERNELS)) == 15
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists(), name
    assert {"readout_bwd_fused", "fused_adamw"} <= set(_build.KERNELS)
    src = (_build.CSRC / "readout_bwd_fused.cu").read_text()
    # bf16: wgmma fed by TMA, a cluster launch; f32: plain FMA; no atomics
    assert "atomicAdd" not in src and "fmaf" in src
    assert "wgmma_m64n256k16" in src and "tma_load" in src and "cudaLaunchKernelEx" in src
    assert "readout_bwd_fused" in trc.LAUNCHES


# -- the bf16 kernel's partition and order of summation ----------------------

SOURCE = (_build.CSRC / "readout_bwd_fused.cu").read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+)\b", SOURCE)
    assert len(found) == 1, name
    return int(found[0])


BM, BK, MAX_RANKS = _constant("kBM"), _constant("kBK"), _constant("kMaxRanks")
THREADS, TAB_MAX = _constant("kConsumerThreads"), _constant("kTabMax")
SMEM_LIMIT = _constant("kSmemLimit")
PITCH_DW, PITCH_DH = (int(v) for v in re.findall(
    r"constexpr int kCpPitchDw = (\d+), kCpPitchDh = (\d+);", SOURCE)[0])
WARPS = THREADS // 32


def stage_geometry(dw: bool):
    """(rows of a dy stage, vectors of 8 columns a row, row lanes)."""
    rows, vpr = (BK, BM // 8) if dw else (BM, BK // 8)
    return rows, vpr, THREADS // vpr


def thread_rows(dw: bool, ranks: int, rank: int, ct: int):
    """The stage rows and the vector consumer thread ``ct`` of ``rank``
    recomputes: the kernel's compute()."""
    rows, vpr, lanes = stage_geometry(dw)
    piece = -(-rows // ranks)
    end = min(rows, rank * piece + piece)
    return range(rank * piece + ct // vpr, end, lanes), ct % vpr


def cut(blocks, steps, out_floats, slots, slab_cost):
    """cut() of the source: (steps a slab, slabs)."""
    best, best_cost, s = 1, None, 1
    while s <= 32 and s <= steps and (s == 1 or s * out_floats <= 64 << 20):
        rounds = -(-blocks * s // slots)
        cost = float(rounds * -(-steps // s)) + (s * slab_cost if s > 1 else 0.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
        s += 1
    per = -(-steps // best)
    return per, -(-steps // per)


def plan_pass(dw: bool, f: int, m_total: int, k_total: int, slots: int) -> dict:
    """plan_pass() of the source for the pass's output rows and loop extent."""
    tile_n, ranks, fgroups = trc.bwd_fused_cluster(f)
    m_tiles, k_steps = -(-m_total // BM), -(-k_total // BK)
    step_s = 2.0 * BM * BK * tile_n / 7.49e12
    slab_cost = 8.0 * m_total * f / 3.35e12 / step_s
    k_per, slabs = cut(fgroups * m_tiles, k_steps, m_total * f, slots, slab_cost)
    return dict(m_tiles=m_tiles, k_steps=k_steps, k_per=k_per, slabs=slabs, ranks=ranks,
                fgroups=fgroups, tile_n=tile_n, units=fgroups * slabs * m_tiles,
                clusters=min(fgroups * slabs * m_tiles, slots))


def unit_steps(pl: dict, unit: int):
    """(F group, slab, output tile, loop steps) of a unit: Work::start."""
    mt = unit % pl["m_tiles"]
    z = unit // pl["m_tiles"] % pl["slabs"]
    fg = unit // (pl["m_tiles"] * pl["slabs"])
    return fg, z, mt, range(z * pl["k_per"], min(pl["k_steps"], (z + 1) * pl["k_per"]))


@pytest.mark.parametrize("dw", [True, False], ids=["dW", "dh"])
@pytest.mark.parametrize("ranks", range(1, MAX_RANKS + 1))
def test_rank_slices_cover_every_dy_element_once(dw, ranks):
    """Every (row, vector) of a dy stage is recomputed by one thread of one
    rank, inside that rank's slice (the rows the publisher bulk-copies to
    the other ranks), and lands at a distinct 16-byte place of the stage."""
    rows, vpr, _ = stage_geometry(dw)
    piece = -(-rows // ranks)
    seen, places = {}, set()
    for rank in range(ranks):
        for ct in range(THREADS):
            rr_range, v = thread_rows(dw, ranks, rank, ct)
            assert len(rr_range) <= 4          # the kernel's rows a thread, at most
            for rr in rr_range:
                assert rank * piece <= rr < min(rows, rank * piece + piece)
                assert (rr, v) not in seen
                seen[(rr, v)] = rank
                cl = 8 * v      # the kernel's swizzled offset
                off = (cl // 64) * 64 * 128 * dw + rr * 128 + ((((cl % 64) // 8) ^ (rr & 7)) << 4)
                assert 0 <= off < BM * BK * 2 and off % 16 == 0 and off not in places
                places.add(off)
    assert set(seen) == {(r, v) for r in range(rows) for v in range(vpr)}


SLAB_GEOMS = [(16, 200, 1024, 95008), (16, 200, 128, 95008), (16, 200, 128, 5120),
              (4, 200, 128, 5120), (2, 37, 64, 300), (3, 50, 64, 1100), (2, 24, 2304, 700)]


@pytest.mark.parametrize("slots", [1, 30, 33, 132])
@pytest.mark.parametrize("geom", SLAB_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_slab_plan_covers_every_step_once(geom, slots):
    """Each pass's units, walked by clusters 0 .. clusters - 1 (unit cluster,
    cluster + clusters, ...), hold every (F group, output tile, loop step)
    once, and no slab is empty."""
    b, t, f, c = geom
    for dw, m_total, k_total in ((True, c, b * t), (False, b * t, c)):
        pl = plan_pass(dw, f, m_total, k_total, slots)
        assert pl["k_per"] * (pl["slabs"] - 1) < pl["k_steps"] <= pl["k_per"] * pl["slabs"]
        seen = []
        for cluster in range(pl["clusters"]):
            for unit in range(cluster, pl["units"], pl["clusters"]):
                fg, _, mt, steps = unit_steps(pl, unit)
                assert len(steps) > 0
                seen += [(fg, mt, k) for k in steps]
        assert sorted(seen) == [(fg, mt, k) for fg in range(pl["fgroups"])
                                for mt in range(pl["m_tiles"]) for k in range(pl["k_steps"])]
    if f > 2048:
        assert pl["fgroups"] == 2       # beyond 8 tiles: a second cluster along F


def layout_bytes(dw, tile_n, tma, piece, rings):
    """layout_of().bytes of the source."""
    yx = (2 * (2 if dw else 1) * piece * 128 + (0 if dw else 2 * BK * 4) if tma
          else 2 * piece * (PITCH_DW if dw else PITCH_DH))
    red = (THREADS // (BM // 8) * BM + 32) * 4 + THREADS * 8 if dw else 0
    y_r, op_r, dy_r = rings
    return (dy_r * BM * BK * 2 + op_r * BK * tile_n * 2 + y_r * yx + red + TAB_MAX * 16
            + 16 * (y_r + op_r + 2 * dy_r) + 1024)


def fit_rings(dw, tile_n, tma, piece):
    """fit_rings() of the source."""
    r = [4, 4, 4]
    while layout_bytes(dw, tile_n, tma, piece, r) > SMEM_LIMIT:
        if r[1] > 2 and r[1] >= r[0]:
            r[1] -= 1
        elif r[0] > 2:
            r[0] -= 1
        elif r[1] > 2:
            r[1] -= 1
        elif r[2] > 3:
            r[2] -= 1
        else:
            break
    return r


@pytest.mark.parametrize("f", [64, 128, 256, 512, 768, 1024, 2048])
def test_every_plan_fits_shared_memory(f):
    """At every F tile and cluster size, both passes, TMA or cp.async: the
    rings fit a block's shared memory with at least 2 y/x and h/W stages and
    3 dy stages (the recomputation runs two steps ahead)."""
    tile_n, ranks, _ = trc.bwd_fused_cluster(f)
    for dw in (True, False):
        piece = -(-(BK if dw else BM) // ranks)
        for tma in (True, False):
            rings = fit_rings(dw, tile_n, tma, piece)
            assert layout_bytes(dw, tile_n, tma, piece, rings) <= SMEM_LIMIT
            assert rings[0] >= 2 and rings[1] >= 2 and rings[2] >= 3


def _warp_sum(vals: np.ndarray) -> np.float32:
    """gn::warp_sum over 32 lanes: xor shuffles 16, 8, 4, 2, 1, in f32."""
    v = vals.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
    return v[0]


def model_bwd_fused(y, x, scale, nb, bias, h, kernel, stats, msums, g, n_elem, groups,
                    lossfun, slots):
    """The bf16 kernel's partition and sums, in f32 (f64 per thread for d
    inv_sigma): outputs as ``readout_bwd_fused`` returns them."""
    b, t, c = y.shape
    f = h.shape[2]
    m = b * t
    xn, da = trc._bwd_terms(y, x, scale, nb, stats, g, n_elem, lossfun)
    dy = ((da * scale.float() - trc._expand(msums[:, 0], c) - xn * trc._expand(msums[:, 1], c))
          * trc._expand(stats[:, 1], c)).reshape(m, c)
    dy_lo = dy.to(y.dtype).float()
    pad_r, pad_c = -(-m // BM) * BM + BM, -(-c // BM) * BM + BM
    d32 = np.zeros((pad_r, pad_c), np.float32)
    d32[:m, :c] = dy.numpy()
    yr = np.zeros((pad_r, pad_c), np.float32)
    yr[:m, :c] = y.float().reshape(m, c).numpy()
    bias_p = np.zeros(pad_c, np.float32)
    bias_p[:c] = bias.numpy()
    hf, wf = h.float().reshape(m, f), kernel.float()
    inv_sigma = float(g[2])

    # dW pass: products per unit, slab partials added in slab order; sums
    pl = plan_pass(True, f, c, m, slots)
    ranks = pl["ranks"]
    rows, vpr, lanes = stage_geometry(True)
    piece = -(-rows // ranks)
    slabs_dw = torch.zeros((pl["slabs"], c, f))
    dbias_p = np.zeros((pl["slabs"] * ranks, c), np.float32)
    dinv_p = np.zeros((pl["slabs"] * ranks, pl["m_tiles"]), np.float32)
    for unit in range(pl["units"]):
        fg, z, mt, steps = unit_steps(pl, unit)
        c0 = mt * BM
        acc = torch.zeros((min(BM, c - c0), f))
        for k in steps:
            r0 = k * BK
            acc += dy_lo[r0:r0 + BK, c0:c0 + BM].t() @ hf[r0:r0 + BK]
        slabs_dw[z, c0:c0 + BM] = acc
        if fg:
            continue
        for rank in range(ranks):
            # thread (lane l, vector v): s_dy[l, v, i] in f32, s_dinv[l, v] in f64
            s_dy = np.zeros((lanes, vpr, 8), np.float32)
            s_dinv = np.zeros((lanes, vpr), np.float64)
            for k in steps:
                for j in range(4):
                    rr = rank * piece + np.arange(lanes) + j * lanes
                    live = (rr < min(rows, rank * piece + piece))[:, None, None]
                    rws = k * BK + np.minimum(rr, rows - 1)
                    cols = c0 + np.arange(BM).reshape(vpr, 8)
                    dv = np.where(live, d32[rws][:, cols], np.float32(0))
                    s_dy = (s_dy + dv).astype(np.float32)
                    ym = (yr[rws][:, cols] - bias_p[cols]).astype(np.float32)
                    part = np.zeros((lanes, vpr), np.float32)
                    for i in range(8):    # fmaf: one rounding of the exact sum
                        part = (dv[..., i].astype(np.float64) * ym[..., i]
                                + part).astype(np.float32)
                    s_dinv += part
            col_sum = np.zeros(BM, np.float32)
            for lane in range(lanes):
                col_sum = (col_sum + s_dy[lane].reshape(BM)).astype(np.float32)
            slot = z * ranks + rank
            dbias_p[slot, c0:c0 + BM] = col_sum[:min(BM, c - c0)]
            per_thread = (s_dinv / inv_sigma).astype(np.float32).reshape(THREADS)
            total = np.float32(0)
            for w in range(WARPS):
                total = np.float32(total + _warp_sum(per_thread[32 * w:32 * w + 32]))
            dinv_p[slot, mt] = total
    dw_p = slabs_dw[0].clone()
    for z in range(1, pl["slabs"]):
        dw_p += slabs_dw[z]
    dbias = dbias_p[0].copy()
    for slot in range(1, dbias_p.shape[0]):
        dbias = (dbias + dbias_p[slot]).astype(np.float32)

    # dh pass: products per unit, slab partials added in slab order
    pl = plan_pass(False, f, m, c, slots)
    slabs_dh = torch.zeros((pl["slabs"], m, f))
    for unit in range(pl["units"]):
        _, z, mt, steps = unit_steps(pl, unit)
        r0 = mt * BM
        for k in steps:
            c0 = k * BK
            slabs_dh[z, r0:r0 + BM] += dy_lo[r0:r0 + BM, c0:c0 + BK] @ wf[c0:c0 + BK]
    dh_p = slabs_dh[0].clone()
    for z in range(1, pl["slabs"]):
        dh_p += slabs_dh[z]
    return (dw_p, dh_p.reshape(b, t, f), torch.from_numpy(dbias),
            torch.tensor(dinv_p.sum(dtype=np.float32)))


MODEL_GEOMS = [(2, 37, 64, 300, 6, "Huber"), (3, 50, 64, 1100, 4, "MAE"),
               (2, 40, 128, 1100, 4, "MSE"), (2, 24, 256, 1100, 4, "smoothL1")]


@pytest.mark.parametrize("slots", [1, 33])
@pytest.mark.parametrize("geom", MODEL_GEOMS, ids=lambda g: "x".join(map(str, g[:4])))
def test_kernel_model_matches_the_plain_version_and_jax(monkeypatch, geom, slots):
    """The model of the kernel's partition and sums, in f32, against
    ``bwd_fused_reference`` and the JAX op's fused backward (Pallas
    ``_bwd_fused_dw_kernel`` in interpret mode where the JAX rule engages it:
    C = 1100; at C = 300 it materializes dy): rtol 1e-5, atol 1e-6."""
    monkeypatch.setenv("SIMULGEN_READOUT_BWD", "fused")
    b, t, f, c, g, lossfun = geom
    assert (jrc.bwd_flavor(b, t, f, c) == "fused") == (c == 1100)
    case = _case(b, t, f, c, seed=7, inv=0.8)
    jh, jk, jb, js, jnb, jx, ji = (jnp.asarray(case[k]) for k in
                                   ("h", "kernel", "bias", "scale", "norm_bias", "x", "inv"))
    _, _, jy, jstats = jrc._forward_parts(jh, jk, jb, js, jnb, jx, ji, g, 1e-5, lossfun)
    gl, gm = 1.0, 0.3
    jdh, jdw, jdbias, _, _, _, jdinv = jrc._bwd(g, 1e-5, lossfun,
                                                (jh, jk, jb, js, jnb, jx, ji, jy, jstats),
                                                (jnp.float32(gl), jnp.float32(gm)))
    tt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()
          if k not in ("inv", "kernel")}
    kernel = torch.from_numpy(np.ascontiguousarray(case["kernel"].T))
    y = torch.from_numpy(np.array(jy))
    stats = torch.from_numpy(np.array(jstats)[:, :, :g])  # JAX keeps G in 128 lanes
    gvec = torch.tensor([gl, gm, float(case["inv"])])
    n_elem = float(b * t * c)
    chain = (tt["x"], tt["scale"], tt["norm_bias"])
    msums = trc.bwd_stats_reference(y, *chain, stats, gvec, n_elem, g, lossfun)[0]
    args = (y, *chain, tt["bias"], tt["h"], kernel, stats, msums, gvec, n_elem, g, lossfun)
    got = model_bwd_fused(*args, slots=slots)
    want = trc.bwd_fused_reference(*args)
    inv = float(case["inv"])
    jax_outs = (np.asarray(jdw).T / inv, np.asarray(jdh) / inv, np.asarray(jdbias),
                np.asarray(jdinv))
    for name, a, w0, j0 in zip(("dW", "dh", "dbias", "dinv_sigma"), got, want, jax_outs):
        np.testing.assert_allclose(a.numpy(), w0.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(a.numpy(), j0, rtol=1e-5, atol=1e-6, err_msg=f"{name} (JAX)")
