"""GRU primitives, sampling, and the CUDA kernels with their plain
versions (`cuda_gru`, `cuda_stacked`, `cuda_decoder`, `cuda_decode`).
Kernel modules build nothing at import; `_build` compiles `csrc/` at first
use.

The exported names are the JAX package's `ops` names. Two signatures keep
their documented differences: every `*_init` takes a `torch.Generator`
where the JAX one takes a key, and `reparameterize(mu, std, eps)` takes its
noise from the caller."""
from music_fader_nets_tpu_torch.ops.gru import (  # noqa: F401
    GRU_GATES,
    gru_cell,
    gru_init,
    gru_scan,
    bigru_final_state,
    bigru_apply,
    linear,
    linear_init,
    linear_apply,
)
from music_fader_nets_tpu_torch.ops.sampling import (  # noqa: F401
    argmax_one_hot,
    reparameterize,
    grad_reverse,
)
