from mt3_tpu_torch.core import config
from mt3_tpu_torch.core.note_sequence import Note, NoteSequence
