"""GRU primitives, sampling, and the CUDA kernels with their plain
versions (`cuda_gru`, `cuda_stacked`, `cuda_decoder`, `cuda_decode`).
Kernel modules build nothing at import; `_build` compiles `csrc/` at first
use."""
