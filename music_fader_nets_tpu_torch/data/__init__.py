"""Corpora, dataset views and batch iteration (own copies of the JAX
package's `data/` modules, which import no JAX), and the VGMIDI
annotation filtering (`vgmidi_labels`)."""
from music_fader_nets_tpu_torch.data.datasets import (  # noqa: F401
    YamahaDataset,
    VGMIDIDataset,
)
from music_fader_nets_tpu_torch.data.corpus import (  # noqa: F401
    get_classic_piano,
    get_vgmidi,
)
from music_fader_nets_tpu_torch.data.loader import batch_iterator  # noqa: F401
