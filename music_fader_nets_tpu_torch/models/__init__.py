"""Model pieces: encoder streams, the attribute sub-decoders, the global
decoder, the four Gaussian-prior families (RegVAE, SingleVAE, CVAE,
FaderNets), the GM-VAE and the single GM-VAE forwards and entry points,
and the fast (kernel-layout) parameter view."""
from music_fader_nets_tpu_torch.models.vae import (  # noqa: F401
    global_decode, reg_vae_global_decode, single_vae_global_decode,
    cvae_global_decode, fader_global_decode,
    init_reg_vae, reg_vae_forward, reg_vae_encode, reg_vae_decode_tokens,
    init_single_vae, single_vae_forward, single_vae_encode,
    init_cvae, cvae_forward, cvae_encode,
    init_fader, fader_forward, fader_encode,
)
from music_fader_nets_tpu_torch.models.gmvae import (  # noqa: F401
    init_reg_gmvae, reg_gmvae_forward, reg_gmvae_encode,
    reg_gmvae_decode_tokens, reg_gmvae_sample_tokens, approx_qy_x,
    reg_gmvae_global_decode, init_single_gmvae, single_gmvae_forward,
)
