from simulgen_vae_tpu_torch.evaluation.evaluator import ReconstructionEvaluator
from simulgen_vae_tpu_torch.evaluation.reconstruction import (
    evaluate_vae_reconstruction,
    evaluate_vae_simple,
)

__all__ = ["ReconstructionEvaluator", "evaluate_vae_reconstruction", "evaluate_vae_simple"]
