"""The repository's workflow tools on the port: the corpus, the training
recipes (shell scripts beside these modules), the report of a run, the
quality gates of the decode configurations and the velocity diagnosis.
Each runs as `python -m mt3_tpu_torch.tools.<name>` with the flags of its
counterpart under tools/."""
