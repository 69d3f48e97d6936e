#!/bin/bash
# ismir2021 piano-flavour training run for the PyTorch port (counterpart of
# tools/run_ismir2021.sh, with the same train CLI flags).
#
# The second published model flavour (512-frame inputs, 127 velocity bins,
# flat programs, no ties; reference gin/ismir2021.gin) trained end to end
# on a piano-only synthetic corpus (`python -m
# mt3_tpu_torch.tools.make_corpus --out corpus_piano --programs 0
# --max_instruments 1 --velocity_bins 127 --no_ties`; with one program in
# the pool a clip holds one instrument, and a larger --max_instruments
# fails in PolyphonicSynthDataSource, as it does in the JAX package).  Diagnose its velocities afterwards with
# `python -m mt3_tpu_torch.tools.velocity_diagnosis --model ismir2021`.
#
# As in run_flagship.sh the trainer exits 75 at --exit_rss_gb and the loop
# relaunches it with --resume, and a watchdog relaunches it when its log
# goes stale (40 minutes here: an evaluation pass writes nothing to the log
# until it ends).  The JAX script's second watchdog, which kills a process
# that stays under 1.2 GB of resident memory after 18 minutes, is left out:
# it caught a hang at TPU initialisation that a CUDA host does not have.
#
# Environment (paths relative to the repository root): RUN (default
# runs/ismir2021_torch), CORPUS (default corpus_piano), STEPS (6000),
# BATCH (64), EVAL_PERIOD (1000), MAX_RESTARTS (10), PYTHON (python3).
#
# Usage: setsid nohup bash mt3_tpu_torch/tools/run_ismir2021.sh \
#            >> runs/ismir2021_torch/wrapper.log 2>&1 &

cd "$(dirname "$0")/../.." || exit 1
RUN=${RUN:-runs/ismir2021_torch}
CORPUS=${CORPUS:-corpus_piano}
LOG=$RUN/train.log
STEPS=${STEPS:-6000}
BATCH=${BATCH:-64}
EVAL_PERIOD=${EVAL_PERIOD:-1000}
MAX_RESTARTS=${MAX_RESTARTS:-10}
PYTHON=${PYTHON:-python3}

# The train split lives only in $CORPUS/cache.  --data below is the
# cache-miss fallback source; if the cache were missing, the train CLI
# would rebuild it from the *validation* clips and then evaluate on the
# same clips (train/eval contamination).  Refuse to start instead.
if ! ls "$CORPUS"/cache/cache-*.tfrecord >/dev/null 2>&1; then
  echo "ERROR: $CORPUS/cache is empty - build the train cache with:"
  echo "  python -m mt3_tpu_torch.tools.make_corpus --out $CORPUS --num 3072 \\"
  echo "      --programs 0 --max_instruments 1 --velocity_bins 127 --no_ties"
  exit 1
fi
mkdir -p "$RUN"

restarts=0
while [ $restarts -lt $MAX_RESTARTS ]; do
  "$PYTHON" -m mt3_tpu_torch.cli.train --model ismir2021 \
    --data "$CORPUS/validation" --cache_dir "$CORPUS/cache" \
    --eval_data "$CORPUS/validation" --eval_examples 16 \
    --eval_period "$EVAL_PERIOD" \
    --steps "$STEPS" --batch_size "$BATCH" --remat --attention flash \
    --bf16 --preload_cache --checkpoint_dir "$RUN/ckpt" \
    --checkpoint_period 1000 --log_dir "$RUN/logs" --log_every 20 \
    --resume --exit_rss_gb 70 \
    >> "$LOG" 2>&1 &
  PID=$!
  echo "$(date -u +%FT%TZ) launched ismir2021 trainer pid $PID (restart $restarts)"
  echo $PID > "$RUN/train.pid"

  while kill -0 $PID 2>/dev/null; do
    sleep 5
    if [ -f "$LOG" ]; then
      stale=$(( $(date +%s) - $(stat -c %Y "$LOG") ))
      if [ $stale -gt 2400 ]; then
        echo "$(date -u +%FT%TZ) watchdog: log stale ${stale}s, killing $PID"
        kill -9 $PID 2>/dev/null
        sleep 5
        break
      fi
    fi
  done

  wait $PID
  code=$?
  echo "$(date -u +%FT%TZ) trainer exited code $code"
  if [ $code -eq 0 ]; then
    echo "$(date -u +%FT%TZ) training complete"
    exit 0
  fi
  restarts=$((restarts + 1))
  sleep 15
done
echo "$(date -u +%FT%TZ) giving up after $MAX_RESTARTS restarts"
exit 1
