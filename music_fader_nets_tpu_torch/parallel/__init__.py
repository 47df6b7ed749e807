"""Data and tensor parallelism on `torch.distributed`: the mesh and its
layout rules (`mesh.py`), the collectives that stand in for GSPMD's
(`collectives.py`) and the start of a run's ranks (`launch.py`)."""
from music_fader_nets_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    fast_pspecs,
    model_shard,
    param_shardings,
    replicated,
    shard_batch,
    shard_params,
)
