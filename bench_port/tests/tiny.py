"""Tiny configurations and cells for the CPU tests: the cells' shapes cut
down, widths and all, so that a run takes a second."""

AUG = dict(noise_prob=0.0, noise_level=0.05, scaling_prob=0.5, scaling_range=[0.9, 1.1],
           mixup_prob=0.5, mixup_alpha=0.2)


def config(dtype="float32", **over):
    cfg = dict(num_param=12, num_time=8, num_node=64, num_filter_enc=[16, 8, 8], small=True,
               latent_dim_end=4, latent_dim=2, batch_size=4, lr=1e-3, alpha=1e6,
               loss_type="MSE", n_epochs=2002, dtype=dtype, use_spectral_norm=True,
               opt_state_dtype="auto", sn_cadence="auto", fused_readout=False,
               augmentation=dict(AUG),
               conditioner=dict(type="mlp", filters=[8, 16], inputs=10, dropout_rate=0.2))
    cfg.update(over)
    return cfg


CNN = dict(type="cnn", filters=[4, 8, 8, 16, 16, 16], image_side=16, spatial_attention=True,
           dropout_rate=0.2)
TRAIN = dict(driver="train_loop", trace_steps=2,
             limits=dict(loss_gap=1e-4, grad_gap=1e-3, change_gap=1e-3))
SWEEP = dict(driver="serve_closed_loop", rows_per_request=6, max_batch=4, pool=5, check_every=2,
             max_checks=5, trace_requests=2, limits=dict(field_gap=1e-4))
INTERACTIVE = dict(driver="serve_closed_loop", rows_per_request=1, max_batch=4, pool=5,
                   wait_for_each=True, check_every=2, max_checks=5, trace_requests=2,
                   limits=dict(field_gap=1e-4))


def run(cell: dict, cfg: dict, seed: int, seconds: float = 0.2):
    import torch

    from benchlib import harness

    torch.manual_seed(0)
    ctx = harness.Ctx("tiny", cell, cfg, seed, seconds, False, torch.device("cpu"))
    return harness.driver(cell["driver"]).run(ctx)
