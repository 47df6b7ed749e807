"""ELBO terms and the families' regularizers (Pati, GM-VAE KL, GLSR,
FaderNets adversarial)."""
from music_fader_nets_tpu_torch.losses.elbo import (  # noqa: F401
    anneal_beta,
    nll_mean,
    kl_std_normal,
    kl_diag_gaussians,
)
from music_fader_nets_tpu_torch.losses.regularizers import (  # noqa: F401
    pati_regularizer,
    adversarial_fader_loss,
    gmm_unsupervised_kl,
    gmm_supervised_kl,
    glsr_regularizer,
)
