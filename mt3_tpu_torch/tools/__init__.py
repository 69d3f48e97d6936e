"""The repository's workflow and measurement tools on the port: the corpus,
the training recipes (shell scripts beside these modules), the report of
a run, the quality gates of the decode configurations, the velocity
diagnosis, the train-step and decode benchmarks with the trace fit, the
cache-read patterns, the host benches and the measurement queues.  Each
runs as `python -m mt3_tpu_torch.tools.<name>` (the scripts through bash)
with the flags of its counterpart under tools/; mt3_tpu_torch.bench is
bench.py's."""
