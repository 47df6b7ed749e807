"""Evaluation: the reconstruction report of every trainer's evaluation
phase, and the controllability metrics of the paper's Table 1
(consistency, restrictiveness, monotonicity)."""
from music_fader_nets_tpu_torch.eval.controllability import (  # noqa: F401
    clean_output,
    get_classes,
    latent_stats,
    latent_monotonicity,
    EvalScores,
    ControllabilityEvaluator,
    SingleVAEControllabilityEvaluator,
    ConditionControllabilityEvaluator,
)
from music_fader_nets_tpu_torch.eval.reconstruction import (  # noqa: F401
    reconstruction_report,
)
