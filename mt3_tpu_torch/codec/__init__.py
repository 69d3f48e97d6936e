from mt3_tpu_torch.codec import event_codec, note_events, run_length, vocabulary
