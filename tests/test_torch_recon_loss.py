"""The VAE's reconstruction loss pair (``ops/recon_loss.py``): the CPU route
against ``losses.make_recon_loss_pair`` bit for bit, values and gradients;
the CPU route under no_grad (evaluation's call); the wrapper's checks; the
launch counters on the CPU and the kernels' names; and ``VAE.forward``'s
unfused path taking the pair. The kernels run
only on the card: the test marked ``chip`` holds them against the plain
pair there and skips without one.

Nothing here imports JAX.
"""

import re

import numpy as np
import pytest
import torch

from simulgen_vae_tpu_torch import losses
from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.models import vae as tvae
from simulgen_vae_tpu_torch.ops import _build
from simulgen_vae_tpu_torch.ops import recon_loss as rl
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
from simulgen_vae_tpu_torch.utils import profiling

FLAGSHIP_N, ODD_N = 95008, 1001
NAMES = sorted(losses.RECON_LOSSES)
UPSTREAM = (1000.0, 0.37)  # g_flavor, g_mse: both terms of the gradient count


def _maps(shape, dtype, device="cpu", seed=0):
    """A field and its target whose differences cross both thresholds (0.1
    and 1), with every seventh element equal (d = 0: the sign's edge)."""
    g = torch.Generator().manual_seed(seed)
    target = 3.0 * torch.rand(shape, generator=g) - 1.5
    pred = target + 0.4 * torch.randn(shape, generator=g)
    pred, target = pred.to(dtype), target.to(dtype)
    pred.view(-1)[::7] = target.view(-1)[::7]
    return pred.to(device), target.to(device)


def _pair_and_grads(fn, pred, target, want_target=True):
    """``fn``'s two losses and the gradients of ``UPSTREAM``-weighted losses
    in pred (and target)."""
    p = pred.detach().clone().requires_grad_()
    t = target.detach().clone().requires_grad_(want_target)
    a, b = fn(p, t)
    g = [torch.tensor(v, device=pred.device) for v in UPSTREAM]
    grads = torch.autograd.grad((a, b), (p, t) if want_target else (p,), g)
    return a.detach(), b.detach(), grads


@pytest.mark.parametrize("n", [FLAGSHIP_N, ODD_N])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_cpu_route_is_the_plain_pair_bit_for_bit(name, dtype, n):
    pred, target = _maps((2, 3, n), dtype)
    for want_target in (True, False):
        got = _pair_and_grads(lambda p, t: rl.recon_loss_pair(p, t, name), pred, target,
                              want_target)
        want = _pair_and_grads(losses.make_recon_loss_pair(name), pred, target, want_target)
        assert got[0].dtype == got[1].dtype == torch.float32 and got[0].dim() == 0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len(got[2]) == len(want[2]) == 1 + want_target
        for a, b in zip(got[2], want[2]):
            assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_route_under_no_grad_gives_the_plain_means(name):
    """Evaluation's call (no autograd): every flavor has the kernels' kind,
    and the CPU route gives the plain pair's two means and builds no graph."""
    assert set(rl.LOSS_KINDS) == set(losses.RECON_LOSSES)
    pred, target = _maps((4, 6, ODD_N), torch.float32, seed=3)
    with torch.no_grad():
        got = rl.recon_loss_pair(pred.requires_grad_(), target, name)
        want = losses.make_recon_loss_pair(name)(pred, target)
    assert all(v.grad_fn is None and v.dim() == 0 for v in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], losses.get_recon_loss(name)(pred, target), rtol=0,
                               atol=0)


def test_f32_reciprocal_is_the_rounded_quotient():
    n = 16 * 200 * FLAGSHIP_N
    assert rl.f32_reciprocal(n) == float(np.float32(1) / np.float32(n))
    assert rl.f32_reciprocal(0.1) == 10.0 and rl.f32_reciprocal(1.0) == 1.0


def _args():
    pred, target = _maps((2, 3, 16), torch.bfloat16)
    return dict(pred=pred, target=target, name="MSE")


BAD = {
    "name": (lambda a: dict(name="L2"), KeyError),
    "half": (lambda a: dict(pred=a["pred"].half(), target=a["target"].half()), TypeError),
    "double": (lambda a: dict(pred=a["pred"].double(), target=a["target"].double()),
               TypeError),
    "mixed_dtypes": (lambda a: dict(target=a["target"].float()), TypeError),
    "shape": (lambda a: dict(target=a["target"][:, :2].contiguous()), ValueError),
    "broadcast": (lambda a: dict(target=a["target"][:1].contiguous()), ValueError),
    "empty": (lambda a: dict(pred=a["pred"][:0], target=a["target"][:0]), ValueError),
    "pred_noncontiguous": (lambda a: dict(pred=a["pred"].transpose(1, 2).contiguous()
                                          .transpose(1, 2)), ValueError),
    "target_noncontiguous": (lambda a: dict(target=a["target"].transpose(0, 1).contiguous()
                                            .transpose(0, 1)), ValueError),
    "device": (lambda a: dict(target=torch.empty(a["target"].shape, dtype=torch.bfloat16,
                                                 device="meta")), ValueError),
    "meta": (lambda a: dict(pred=torch.empty((2, 3, 16), dtype=torch.bfloat16, device="meta"),
                            target=torch.empty((2, 3, 16), dtype=torch.bfloat16,
                                               device="meta")), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_raises_on_what_the_kernels_do_not_take(case):
    args = _args()
    change, err = BAD[case]
    args.update(change(args))
    with pytest.raises(err):
        rl.recon_loss_pair(**args)


GLOBAL = re.compile(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\s*\(")


def test_cpu_tensors_launch_nothing_and_the_kernels_are_counted():
    rl.reset_launch_counts()
    pred, target = _maps((2, 3, 16), torch.float32)
    _pair_and_grads(lambda p, t: rl.recon_loss_pair(p, t, "Huber0.1"), pred, target)
    assert rl.LAUNCHES == {"recon_loss_pair_fwd": 0, "recon_loss_pair_bwd": 0}
    assert {"recon_loss_pair_fwd", "recon_loss_pair_bwd"} <= set(profiling.counters())
    assert "recon_loss" in _build.KERNELS
    src = (_build.CSRC / "recon_loss.cu").read_text()
    # the benchmark's reader finds the kernels by "recon_loss_pair", and no
    # other reader by its own pattern
    names = GLOBAL.findall(src)
    assert set(names) == {"recon_loss_pair_fwd_kernel", "recon_loss_pair_fwd_finalize_kernel",
                          "recon_loss_pair_bwd_kernel"}
    for other in ("gn_", "readout_", "field_epilogue", "fused_adamw", "grad_norm"):
        assert not any(other in n for n in names)


GEOM = dict(num_param=8, num_time=6, num_node=40, latent_dim_end=8, latent_dim=4,
            num_filter_enc=[16, 8, 8], small=True, n_epochs=4, batch_size=4, lr=1e-3,
            alpha=100.0)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vae_forward_takes_the_pair_on_its_unfused_path(dtype, fused, monkeypatch):
    """The unfused train path computes its two losses with
    ``recon_loss_pair(x_hat, x, lossfun)``; the fused readout's kernels
    carry their own loss and never call it."""
    trainer = VAETrainer(VAEConfig(**GEOM, dtype=dtype, loss_type="Huber"), device="cpu",
                         fused_readout=fused)
    model = trainer.init_state(0).model
    x = (0.3 * torch.randn(4, 6, 40, generator=torch.Generator().manual_seed(0))).to(
        trainer.dtype)
    calls = []
    real = tvae.recon_loss_pair

    def spy(pred, target, name):
        out = real(pred, target, name)
        calls.append((pred, target, name, out))
        return out

    monkeypatch.setattr(tvae, "recon_loss_pair", spy)
    x_hat, recon, _, mse = model(x, torch.Generator().manual_seed(1),
                                 fused_readout_loss=fused)
    if fused:
        assert calls == [] and x_hat is None
        return
    (pred, target, name, out), = calls
    assert pred is x_hat and target is x and name == "Huber"
    assert recon is out[0] and mse is out[1] and recon.requires_grad
    want = losses.make_recon_loss_pair("Huber")(x_hat.detach(), x)
    assert torch.equal(recon.detach(), want[0]) and torch.equal(mse.detach(), want[1])


# -- on the card ------------------------------------------------------------------

CARD_CASES = {"flagship": (FLAGSHIP_N, 0), "odd": (ODD_N, 0), "odd_shifted": (ODD_N, 1)}


def _on_card(pred, target, shift):
    """Copies of the maps on the card, their bases ``shift`` elements past an
    allocation's (16-byte aligned) start."""
    out = []
    for m in (pred, target):
        buf = torch.empty(m.numel() + shift, dtype=m.dtype, device="cuda")
        v = buf[shift:].view(m.shape)
        v.copy_(m)
        out.append(v)
    return out


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_kernels_against_the_plain_pair_on_the_card(name, dtype, case):
    """The gradients bit for bit the plain backward's (pred's and target's),
    the two losses within 1e-6 of the plain f32 means, two calls the same
    bits, and a CUDA graph's replay of both passes the eager calls' bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU version")
    n, shift = CARD_CASES[case]
    pred, target = _on_card(*_maps((3, 5, n), dtype, seed=n + shift), shift)
    rl.reset_launch_counts()
    got = _pair_and_grads(lambda p, t: rl.recon_loss_pair(p, t, name), pred, target)
    again = _pair_and_grads(lambda p, t: rl.recon_loss_pair(p, t, name), pred, target)
    want = _pair_and_grads(losses.make_recon_loss_pair(name), pred, target)
    torch.cuda.synchronize()
    assert rl.LAUNCHES == {"recon_loss_pair_fwd": 2, "recon_loss_pair_bwd": 2}
    for a, b in zip(got[2], want[2]):
        assert a.dtype == dtype and torch.equal(a, b)
    for i in (0, 1):
        assert abs(float(got[i]) - float(want[i])) <= 1e-6 * abs(float(want[i]))
    assert all(torch.equal(a, b) for a, b in zip(got[:2] + got[2], again[:2] + again[2]))

    g = [torch.tensor(v, device="cuda") for v in UPSTREAM]
    eager = (*rl.recon_loss_pair_fwd(pred, target, name),
             *rl.recon_loss_pair_bwd(pred, target, *g, name, True, True))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (*rl.recon_loss_pair_fwd(pred, target, name),
                    *rl.recon_loss_pair_bwd(pred, target, *g, name, True, True))
    for t in captured:
        t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))
    assert torch.equal(eager[0], got[0]) and torch.equal(eager[2], got[2][0])
