"""Command-line entry point of the port: the training pipeline
(``simulgen_vae_tpu/cli.py``).

    python -m simulgen_vae_tpu_torch --preset=1 --plot=2 --lc_only=0 --size=small

Stages: config parsing -> dataset load and reduction -> the field scaler ->
VAE training -> latent extraction -> latent-conditioner training -> the
reconstruction comparison. The artifacts are the JAX package's CLI's, in its
formats (flax msgpack models, sklearn-layout scaler pickles), so that either
package's generate CLI serves them:

* ``model_save/``: ``SimulGen-VAE``, ``LatentConditioner``, ``scaler.pkl``,
  ``latent_vectors.npy``, ``xs.npy``, ``latent_vectors_scaler.pkl``,
  ``xs_scaler.pkl``, ``latent_conditioner_input_scaler.pkl``;
* ``SimulGen-VAE_L2_loss.txt``, the per-sample reconstruction MSEs;
* ``checkpoints/``: the train states (``vae/``, ``latent_conditioner/``,
  the port's own ``ckpt_*.pt`` files) and the comparison PNGs.

The run is on ``cuda`` unless ``--device cpu``; asking for CUDA where there
is none raises. matplotlib draws the PNGs where it is installed; without it
each PNG set is skipped with one line saying so, and ``--plot 0|1`` (the
dataset plots, asked for explicitly) raises before training starts.

The conditioner follows the condition file's ``input_type``: the MLP on
the CSV (``csv``), the CNN (``image``, spectral norm on its ``sn_*``
layers) or the ViT (``image_vit``; its widths from the file's optional
``vit_embed_dim``, ``vit_depth`` and ``vit_num_heads``, 256 / 6 / 8 without
them, 768 / 12 / 12 for ViT-B/16) on the images of ``param_dir`` (OpenCV's
reader, imported where it reads; pixels / 255), or the MLP on the PCA
coefficients of those images (``image_pca``: a 256-component PCA fitted on
the raw pixels on the run's device and saved as ``model_save/
pca_full_comp{k}.pkl``, k the components kept; the coefficients go through a
fresh ``latent_conditioner_input_scaler.pkl``). Images train through
``LCTrainer`` with augmentation, or with ``use_e2e_training`` through
``E2ETrainer`` and the frozen decoder; ``image_pca`` trains through
``LCTrainer`` as the CSV does, with or without ``use_e2e_training``, as in
JAX's CLI. The ``LatentConditioner`` file holds ``{"params",
"batch_stats"}`` with the raw kernels, as JAX's CLI saves it.

Several devices: under ``torchrun`` (one process a device) the VAE trains
on a ``('data', 'model')`` mesh, ``--mesh_data`` x ``--mesh_model`` (all
ranks on ``data`` by default, as JAX's ``make_mesh()``):

    torchrun --nproc_per_node 4 -m simulgen_vae_tpu_torch --preset=1 --mesh_data 2 --mesh_model 2

Rank 0 writes every file; the others wait for it where the JAX CLI does
(``folder-init``, ``vae-artifacts``). After the VAE every rank evaluates,
extracts the latents and trains the conditioner on the whole gathered
``eval_params``, as every JAX process does; the conditioner's checkpoints of
the other ranks go to a temporary directory. Without torchrun the run is one
device, as before.

``--lc_only=1`` reads the port's VAE checkpoint (``checkpoints/vae/
ckpt_*.pt``), not the JAX package's orbax one.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from simulgen_vae_tpu_torch import convert
from simulgen_vae_tpu_torch.config import (
    LCConfig,
    VAEConfig,
    input_user_variables,
    parse_condition_file,
    parse_training_parameters,
    read_preset,
)
from simulgen_vae_tpu_torch.data.dataset import input_dataset, reduce_dataset
from simulgen_vae_tpu_torch.data import images
from simulgen_vae_tpu_torch.data.scaler import data_scaler, latent_conditioner_scaler
from simulgen_vae_tpu_torch.evaluation import (
    ReconstructionEvaluator,
    evaluate_vae_reconstruction,
)
from simulgen_vae_tpu_torch.evaluation.plotter import (
    dual_view_plotter,
    have_matplotlib,
    temporal_plotter,
)
from simulgen_vae_tpu_torch.models.conditioner_cnn import sn_filter
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.parallel import (
    initialize_distributed,
    is_primary,
    make_mesh,
    sync_processes,
)
from simulgen_vae_tpu_torch.train.lc_e2e_trainer import E2ETrainer
from simulgen_vae_tpu_torch.train.lc_trainer import LCTrainer
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
from simulgen_vae_tpu_torch.utils import preemption, resolve_device
from simulgen_vae_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    save_flax_model,
    save_l2_loss,
    save_latents,
)
from simulgen_vae_tpu_torch.utils.logging import MetricsLogger
from simulgen_vae_tpu_torch.utils.summary import train_state_summary

def initialize_folder(folder_name: str) -> None:
    """Create ``folder_name`` and delete everything in it."""
    os.makedirs(folder_name, exist_ok=True)
    for item in os.listdir(folder_name):
        path = os.path.join(folder_name, item)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SimulGen-VAE on PyTorch: train the VAE and the latent conditioner",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""Examples:
  Full run : python -m simulgen_vae_tpu_torch --preset=1 --plot=2 --lc_only=0 --size=small
  LC only  : python -m simulgen_vae_tpu_torch --preset=1 --lc_only=1 --size=small
  CPU      : python -m simulgen_vae_tpu_torch --preset=1 --plot=2 --device cpu
  Mesh     : torchrun --nproc_per_node 4 -m simulgen_vae_tpu_torch --preset=1 --mesh_data=2 --mesh_model=2""",
    )
    parser.add_argument("--preset", dest="preset", default="1")
    parser.add_argument("--plot", dest="plot", default="2",
                        help="0|1: also plot the dataset (needs matplotlib); 2: no plots")
    parser.add_argument("--lc_only", dest="train_latent_conditioner",
                        default="0")
    parser.add_argument("--size", dest="size", default="small",
                        choices=["small", "large"])
    parser.add_argument("--load_all", dest="load_all", default="1",
                        help="--load_all=0 keeps the dataset in host memory and "
                             "streams batches to the device (same as --stream)")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="data-parallel mesh axis size (default: all ranks)")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="model-parallel mesh axis size (node-axis split)")
    parser.add_argument("--condition", default="input_data/condition.txt")
    parser.add_argument("--preset_file", default="preset.txt")
    parser.add_argument("--opt_state_dtype", default="auto",
                        choices=["auto", "float32", "bfloat16", "bfloat16_rtn"],
                        help="AdamW moment storage; auto = float32")
    parser.add_argument("--sn_cadence", default="auto",
                        choices=["auto", "step", "epoch"],
                        help="spectral-norm power-iteration refresh; auto = per step")
    parser.add_argument("--lc_loss_mode", default="standard",
                        choices=["standard", "enhanced"],
                        help="latent-conditioner loss: 'standard' = 10 MSE(main) + "
                             "MSE(hier); 'enhanced' = the MSE/MAE/smooth-L1 blend "
                             "plus the perceptual term")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--epochs", type=int, default=None,
                        help="override Training_epochs")
    parser.add_argument("--lc_epochs", type=int, default=None,
                        help="override n_epoch")
    parser.add_argument("--no_wipe", action="store_true",
                        help="skip the destructive folder init")
    parser.add_argument("--resume", action="store_true",
                        help="resume VAE and LC training from the latest checkpoints")
    parser.add_argument("--auto_resume", action="store_true",
                        help="like --resume, and safe on a fresh run (resumes only "
                             "where a checkpoint exists); on SIGTERM the trainers "
                             "checkpoint and the run exits 75 (EX_TEMPFAIL)")
    parser.add_argument("--no_preempt_guard", action="store_true",
                        help="do not install the SIGTERM checkpoint-and-requeue handler")
    parser.add_argument("--stream", action="store_true",
                        help="stream batches from host memory")
    parser.add_argument("--no_nan_guard", action="store_true",
                        help="disable the VAE's divergence detection (non-finite "
                             "train loss -> rollback to the last checkpoint)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="device to train on (default cuda; 'cpu' for the plain versions)")
    return parser


def resolve_load_all(args) -> None:
    """``--load_all=0`` takes the streaming path."""
    if str(args.load_all) in ("0", "false", "False"):
        args.stream = True


def _refuse_unported(lc_cfg: LCConfig) -> None:
    if lc_cfg.input_type not in ("csv", "image_pca", *convert.IMAGE_INPUT_TYPES):
        raise NotImplementedError(
            f"Unrecognized latent_conditioner_data_type: {lc_cfg.input_type}. "
            'Supported options: "image" (CNN), "image_vit" (ViT), '
            '"image_pca" (PCA->MLP), "csv" (MLP)')


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_load_all(args)
    if args.auto_resume:
        args.resume = True
    if not args.no_preempt_guard:
        preemption.install()
    device = initialize_distributed(resolve_device(args.device))
    mesh = make_mesh(args.mesh_data, args.mesh_model)
    primary = is_primary()

    params = parse_condition_file(args.condition)
    config = parse_training_parameters(params)
    if args.preset == "1":
        data_no, _, num_filter_enc, lc_filter = read_preset(args.preset_file)
    else:
        data_no, _, num_filter_enc, lc_filter = input_user_variables()

    lc_only = int(args.train_latent_conditioner)
    cfg = VAEConfig.from_condition(config, num_filter_enc, small=args.size == "small",
                                   dtype=args.dtype)
    cfg.opt_state_dtype = args.opt_state_dtype
    cfg.sn_cadence = args.sn_cadence
    if args.epochs is not None:
        cfg.n_epochs = args.epochs
    lc_cfg = LCConfig.from_condition(config, lc_filter)
    if args.lc_epochs is not None:
        lc_cfg.epochs = args.lc_epochs
    _refuse_unported(lc_cfg)
    if args.plot != "2" and not have_matplotlib():
        raise RuntimeError(f"--plot {args.plot} draws the dataset with matplotlib, which "
                           "is not installed; pass --plot=2 to train without plots")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    if primary:
        print(f"Starting SimulGen-VAE (PyTorch) on {device} ({name})...")
    print(f"Mesh: {dict(mesh.shape)}")

    if primary:
        if lc_only == 0 and not args.no_wipe and not args.resume:
            for folder in ("model_save", "checkpoints", "LatentConditionerRuns", "output"):
                initialize_folder(folder)
        os.makedirs("model_save", exist_ok=True)
        os.makedirs("checkpoints", exist_ok=True)
    sync_processes("folder-init")  # no rank may write before the wipe

    # -- data ----------------------------------------------------------------
    data_save = input_dataset(config["num_param"], config["num_time"],
                              config["num_node"], data_no)
    num_node_red = config["num_node_end"] - config["num_node_start"]
    num_time, fom_data, num_node = reduce_dataset(
        data_save, config["num_time_to"], num_node_red, config["num_param"],
        config["num_time"], config["num_node_start"], config["num_node_end"],
    )
    del data_save

    if args.plot != "2" and primary:
        os.makedirs("output", exist_ok=True)
        start = min(7, fom_data.shape[0] - 1)
        dual_view_plotter(fom_data, param_idx=start, print_graph=args.plot,
                          save_path="output/dual_view.png")
        temporal_plotter(fom_data, 0, start, 0, args.plot,
                         min(7, fom_data.shape[0] - start),
                         save_path="output/temporal.png")

    new_x_train, _, _ = data_scaler(fom_data, num_time, num_node,
                                    save_path="model_save/scaler.pkl" if primary else None)
    del fom_data
    new_x_train = np.asarray(new_x_train, np.float32)
    if primary:
        print(f"Dataset value range: [{new_x_train.min():.4f}, {new_x_train.max():.4f}]")

    # -- VAE -----------------------------------------------------------------
    trainer = VAETrainer(cfg, device=device, seed=args.seed)
    if lc_only == 0:
        trainer.set_mesh(mesh)
        ckpt = CheckpointManager("checkpoints/vae",
                                 save_interval_epochs=max(cfg.n_epochs // 10, 1))
        state = trainer.init_state(args.seed)
        remaining = cfg.n_epochs
        if args.resume and ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            remaining = max(cfg.n_epochs - int(state.epoch), 0)
            if primary:
                print(f"Resuming from epoch {int(state.epoch)} "
                      f"({remaining} epochs remaining)")
        if primary:
            block = " (rank 0's block)" if state.layout is not None else ""
            print(train_state_summary(state, "SimulGen-VAE" + block))
        logger = MetricsLogger(log_dir="./runs", name="VAE",
                               samples_per_epoch=int(len(new_x_train) * 0.8),
                               n_chips=mesh.size)
        state, _ = trainer.fit(
            new_x_train, args.seed, state=state, stream=args.stream, epochs=remaining,
            ckpt_manager=ckpt, log_fn=lambda e, m: logger.log(e, m, cfg.n_epochs),
            nan_guard=not args.no_nan_guard,
        )
        logger.close()
        if preemption.requested():
            print(f"Preempted at epoch {int(state.epoch)}: train state "
                  f"checkpointed; rerun with --resume to continue "
                  f"(exit {preemption.EX_TEMPFAIL})")
            return preemption.EX_TEMPFAIL

        vae_model = trainer.eval_params(state)  # whole, on every rank
        del state  # the moments are not needed past this point
        if primary:
            save_flax_model("model_save/SimulGen-VAE",
                            {"params": convert.vae_tree(vae_model, cfg)})

        n_train = int(len(new_x_train) * 0.8)
        for rows, label in ((slice(0, n_train), "Training Reconstruction"),
                            (slice(n_train, None), "Validation")):
            evaluate_vae_reconstruction(
                vae_model, new_x_train[rows], args.seed, recon_iter=cfg.recon_iter,
                batch_size=cfg.batch_size, dataset_name=label, verbose=primary,
                save_images=primary)
        latent_vectors, hierarchical, recon_loss, _, _ = evaluate_vae_reconstruction(
            vae_model, new_x_train, args.seed, recon_iter=cfg.recon_iter,
            batch_size=cfg.batch_size, dataset_name="Whole Dataset", verbose=primary)
        if primary:
            save_latents("model_save", latent_vectors, hierarchical)
            save_l2_loss("./SimulGen-VAE_L2_loss.txt", recon_loss)
        sync_processes("vae-artifacts")  # the conditioner's stage reads these files
    else:
        print("Training LatentConditioner only...")
        latent_vectors = np.load("model_save/latent_vectors.npy")
        hierarchical = np.load("model_save/xs.npy")
        state = CheckpointManager("checkpoints/vae").restore(trainer.init_state(args.seed))
        if primary:
            print(train_state_summary(state, "SimulGen-VAE"))
        vae_model = trainer.eval_params(state)
        del state

    return run_latent_conditioner_stage(args, cfg, lc_cfg, vae_model, latent_vectors,
                                        hierarchical, new_x_train, device)


def _maybe_resume_lc(args, trainer, lc_ckpt: CheckpointManager, total_epochs: int):
    """The LC's initial state (restored from the latest checkpoint under
    ``--resume``) and the epochs left to train."""
    state = trainer.init_state(args.seed)
    if not getattr(args, "resume", False) or lc_ckpt.latest_step() is None:
        return state, total_epochs
    state = lc_ckpt.restore(state)
    remaining = max(total_epochs - int(state.epoch), 0)
    print(f"Resuming LatentConditioner from epoch {int(state.epoch)} "
          f"({remaining} epochs remaining)")
    return state, remaining


def read_conditioner_inputs(lc_cfg: LCConfig, device, write: bool = True) -> np.ndarray:
    """The conditioner's inputs: pixels / 255 of the images of ``param_dir``;
    or, scaled by a fresh ``latent_conditioner_input_scaler.pkl``, the CSV
    or the PCA coefficients of those images (the PCA fitted on ``device``).
    ``write=False`` fits the same but saves neither file (a mesh's ranks
    other than 0)."""
    if lc_cfg.input_type in convert.IMAGE_INPUT_TYPES:
        print("Loading image data...")
        physical_input, _ = images.read_latent_conditioner_dataset_img(
            lc_cfg.param_dir, lc_cfg.param_data_type)
        return physical_input / 255.0
    if lc_cfg.input_type == "image_pca":
        print("Loading image data with PCA preprocessing for MLP...")
        physical_input, _ = images.read_latent_conditioner_dataset_img_pca(
            lc_cfg.param_dir, lc_cfg.param_data_type, device=device, save=write)
    else:
        print("Loading csv data for MLP...")
        physical_input = images.read_latent_conditioner_dataset(lc_cfg.param_dir)
    physical_input, _ = latent_conditioner_scaler(
        physical_input, "./model_save/latent_conditioner_input_scaler.pkl" if write else None)
    return physical_input


def run_latent_conditioner_stage(args, cfg: VAEConfig, lc_cfg: LCConfig, vae_model,
                                 latent_vectors, hierarchical, new_x_train,
                                 device) -> int:
    """Read the conditioner's inputs, scale the latents, train the conditioner
    (through the frozen decoder with ``use_e2e_training`` on images), save it
    and compare its reconstructions with the VAE's own. Returns the exit
    code (75 when preempted)."""
    num_param = latent_vectors.shape[0]
    out_latent = latent_vectors.reshape(num_param, cfg.latent_dim_end)
    xs_vectors = hierarchical.reshape(num_param, -1)

    data_type = lc_cfg.input_type
    is_image = data_type in convert.IMAGE_INPUT_TYPES
    primary = is_primary()
    physical_input = read_conditioner_inputs(lc_cfg, device, write=primary)
    out_latent, lv_scaler = latent_conditioner_scaler(
        out_latent, "./model_save/latent_vectors_scaler.pkl" if primary else None)
    out_hier_flat, xs_scaler = latent_conditioner_scaler(
        xs_vectors, "./model_save/xs_scaler.pkl" if primary else None)
    size2 = cfg.num_hier
    out_hier = out_hier_flat.reshape(num_param, size2, cfg.latent_dim)
    n_in = physical_input.shape[-1]

    lc_sn = None
    if is_image:
        lc_model = convert.image_conditioner(lc_cfg, cfg, device,
                                             image_side=int(round(np.sqrt(n_in))))
        lc_sn = sn_filter if data_type == "image" else None
        if data_type == "image_vit":
            print(f"ViT conditioner: embedding {lc_cfg.vit_embed_dim}, depth "
                  f"{lc_cfg.vit_depth}, {lc_cfg.vit_num_heads} heads")
    else:
        lc_model = LatentConditioner(lc_cfg.filters, cfg.latent_dim_end, n_in, cfg.latent_dim,
                                     size2, device, lc_cfg.dropout_rate)
    logger = MetricsLogger(log_dir="./LatentConditionerRuns", name="LatentConditioner")
    print("Starting LatentConditioner training...")
    with contextlib.ExitStack() as stack:
        # every rank trains the conditioner; rank 0's checkpoints are the run's
        ckpt_dir = ("checkpoints/latent_conditioner" if primary
                    else stack.enter_context(tempfile.TemporaryDirectory()))
        return _train_conditioner(args, cfg, lc_cfg, vae_model, lc_model, lc_sn, logger,
                                  ckpt_dir, physical_input, out_latent, out_hier,
                                  new_x_train, lv_scaler, xs_scaler, n_in, device, primary)


def _train_conditioner(args, cfg, lc_cfg, vae_model, lc_model, lc_sn, logger, ckpt_dir,
                       physical_input, out_latent, out_hier, new_x_train, lv_scaler,
                       xs_scaler, n_in, device, primary) -> int:
    """The conditioner's training, its file and the comparison (the rest of
    :func:`run_latent_conditioner_stage`)."""
    data_type = lc_cfg.input_type
    is_image = data_type in convert.IMAGE_INPUT_TYPES
    lc_ckpt = CheckpointManager(ckpt_dir, save_interval_epochs=max(lc_cfg.epochs // 10, 1))
    log_fn = lambda e, m: logger.log(e, m, lc_cfg.epochs)  # noqa: E731
    if is_image and lc_cfg.use_e2e_training:
        print("Using end-to-end latent conditioner training")
        trainer = E2ETrainer(
            lc_model, vae_model, lv_scaler, xs_scaler, epochs=lc_cfg.epochs, lr=lc_cfg.lr,
            batch_size=lc_cfg.batch_size, weight_decay=lc_cfg.weight_decay,
            loss_function=lc_cfg.e2e_loss_function, lc_alpha=lc_cfg.lc_alpha,
            use_latent_regularization=lc_cfg.use_latent_regularization,
            latent_reg_weight=lc_cfg.latent_reg_weight, sn_filter=lc_sn, device=device,
            seed=args.seed)
        lc_state, remaining = _maybe_resume_lc(args, trainer, lc_ckpt, lc_cfg.epochs)
        print(train_state_summary(lc_state, "LatentConditioner (E2E)"))
        lc_state, _ = trainer.fit(physical_input, out_latent, out_hier, new_x_train,
                                  args.seed, state=lc_state, epochs=remaining,
                                  ckpt_manager=lc_ckpt, log_fn=log_fn)
    else:
        trainer = LCTrainer(lc_model, epochs=lc_cfg.epochs, lr=lc_cfg.lr,
                            batch_size=lc_cfg.batch_size, weight_decay=lc_cfg.weight_decay,
                            loss_mode=args.lc_loss_mode, device=device, seed=args.seed,
                            is_image_data=is_image, sn_filter=lc_sn)
        lc_state, remaining = _maybe_resume_lc(args, trainer, lc_ckpt, lc_cfg.epochs)
        print(train_state_summary(lc_state, f"LatentConditioner ({data_type})"))
        lc_state, _ = trainer.fit(physical_input, out_latent, out_hier, args.seed,
                                  state=lc_state, epochs=remaining, ckpt_manager=lc_ckpt,
                                  log_fn=log_fn)
    logger.close()
    lc_ckpt.close()

    if preemption.requested():
        print(f"Preempted at LC epoch {int(lc_state.epoch)}: state "
              f"checkpointed; rerun with --resume to continue "
              f"(exit {preemption.EX_TEMPFAIL})")
        return preemption.EX_TEMPFAIL

    # the raw kernels (no sigma) and the BatchNorms' running statistics
    if primary:
        save_flax_model("model_save/LatentConditioner",
                        convert.conditioner_variables(lc_state.model, lc_cfg, cfg, n_in))

    print("LatentConditioner training completed successfully")
    print("Starting reconstruction evaluation...")
    if isinstance(trainer, E2ETrainer):  # the raw weights in eval mode, as JAX's CLI compares
        @torch.no_grad()
        def predict(x):
            return lc_state.model(x)
    else:
        predict = trainer.predict_fn(lc_state)
    evaluator = ReconstructionEvaluator(vae_model, batch_size=cfg.batch_size, seed=args.seed)
    evaluator.evaluate_reconstruction_comparison(
        predict, physical_input, out_latent, out_hier, new_x_train,
        lv_scaler, xs_scaler, save_dir="checkpoints", save_plots=primary,
    )

    # Mirror the comparison plots into TensorBoard where it is installed.
    img_logger = MetricsLogger(log_dir="./LatentConditionerRuns",
                               name="LatentConditioner", console=False)
    for i, png in enumerate(sorted(glob.glob("checkpoints/*.png"))[:10]):
        img_logger.log_image_file(
            f"reconstruction/{os.path.basename(png)[:-4]}", png, step=i)
    img_logger.close()
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
