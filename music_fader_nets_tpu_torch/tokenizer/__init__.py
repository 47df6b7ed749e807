"""The host-side tokenizer: MIDI notes, the 342-token performance codec,
the quantized pianoroll and its attributes, key estimation and the corpus
pipeline (own copies of the pure-Python paths of
`music_fader_nets_tpu/tokenizer/`; numpy and the standard library only)."""
from music_fader_nets_tpu_torch.tokenizer.midi_io import (  # noqa: F401
    MidiNote, MidiData, read_midi, write_midi,
)
from music_fader_nets_tpu_torch.tokenizer.event_codec import (  # noqa: F401
    encode_pianoroll, decode_events, pitch_lists_to_rhythm,
)
from music_fader_nets_tpu_torch.tokenizer.performance_codec import (  # noqa: F401
    performance_encode, performance_decode, EVENT_DIMS,
)
from music_fader_nets_tpu_torch.tokenizer.attributes import (  # noqa: F401
    get_music_attributes,
)
from music_fader_nets_tpu_torch.tokenizer.key_estimate import (  # noqa: F401
    harmony_vector_from_chroma, harmony_vector_from_notes,
)
