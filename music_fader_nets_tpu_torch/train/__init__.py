"""Training: the six families' objectives, their noise rule, the Trainer
and its optimizer."""
from music_fader_nets_tpu_torch.train.objectives import (  # noqa: F401
    vanilla_loss, gmm_loss, glsr_loss, cvae_loss, fader_loss, singlevae_loss,
    draw_noise,
)
from music_fader_nets_tpu_torch.train.trainer import (  # noqa: F401
    Trainer, TrainState, make_optimizer,
)
