"""Metrics logging (``simulgen_vae_tpu/utils/logging.py``): one console line
per epoch in the reference's format, and TensorBoard scalars where
tensorboardX is installed (the card's machine has none: the logger then
writes the console only). tensorboardX and PIL are imported at first use.
On a mesh only rank 0 writes either (``parallel.is_primary``)."""

from __future__ import annotations

import logging
from typing import Dict, Optional

from simulgen_vae_tpu_torch.parallel.mesh import is_primary

LOG_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"


def epoch_log_line(epoch: int, epochs: int, m: Dict[str, float]) -> str:
    """``[Epoch e/E] Loss: ... Time: ...s ETA: ...h LR: ...``."""
    eta_h = (epochs - epoch) * m.get("epoch_time", 0.0) / 3600
    return ("[Epoch {}/{}] Loss: {:.4E}   val_loss: {:.2E}   Recon:{:.4E}   "
            "Recon_val:{:.4E}   KL:{:.4E}   Beta:{:.4E}   AvgGrad:{:.4E}   "
            "Time: {:.2f}s   ETA: {:.2f}h    LR: {:.2E}").format(
        epoch + 1, epochs, m.get("loss", 0.0), m.get("val_loss", 0.0),
        m.get("recon", 0.0), m.get("val_recon", 0.0),
        m.get("kl", 0.0), m.get("beta", 0.0), m.get("grad_norm", 0.0),
        m.get("epoch_time", 0.0), eta_h, m.get("lr", 0.0),
    )


class MetricsLogger:
    """TensorBoard scalar writer (tensorboardX, where installed) + console
    lines through :mod:`logging`."""

    def __init__(self, log_dir: str = "./runs", name: str = "VAE",
                 console: bool = True, samples_per_epoch: Optional[int] = None,
                 n_chips: int = 1):
        self.name = name
        self.console = console and is_primary()
        self.samples_per_epoch = samples_per_epoch
        self.n_chips = max(n_chips, 1)
        self.writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            if is_primary():
                self.writer = SummaryWriter(log_dir=log_dir, comment=name)
        logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
        self.logger = logging.getLogger(name)

    def log(self, epoch: int, metrics: Dict[str, float],
            total_epochs: Optional[int] = None) -> None:
        metrics = dict(metrics)
        if self.samples_per_epoch and metrics.get("epoch_time"):
            metrics["samples_per_sec_per_chip"] = (
                self.samples_per_epoch / metrics["epoch_time"] / self.n_chips)
        if self.writer is not None:
            for k, v in metrics.items():
                try:
                    self.writer.add_scalar(f"{self.name}/{k}", float(v), epoch)
                except (TypeError, ValueError):
                    pass
        if self.console:
            self.logger.info(
                epoch_log_line(epoch, total_epochs or epoch + 1, metrics)
            )

    def log_image(self, tag: str, image, step: int = 0) -> None:
        """Write an HWC image (uint8 or [0, 1] float array) to TensorBoard."""
        if self.writer is not None:
            self.writer.add_image(f"{self.name}/{tag}", image, step, dataformats="HWC")

    def log_image_file(self, tag: str, path: str, step: int = 0) -> None:
        """Mirror a saved PNG into TensorBoard (needs PIL besides tensorboardX)."""
        if self.writer is None:
            return
        try:
            import numpy as np
            from PIL import Image
        except ImportError:
            return
        with Image.open(path) as img:
            self.log_image(tag, np.asarray(img.convert("RGB")), step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
