#!/bin/bash
# Flagship training wrapper for the PyTorch port (counterpart of
# tools/run_flagship.sh, with the same train CLI flags).
#
# mt3 at full width, batch 256, remat, bf16 flash attention, from the
# segment cache of a corpus built by `python -m
# mt3_tpu_torch.tools.make_corpus --out corpus`.  The trainer checkpoints
# and exits with code 75 once the host's resident memory passes
# --exit_rss_gb; this wrapper relaunches it with --resume until the target
# step count is reached.  A watchdog kills and relaunches the trainer if
# its log goes stale for more than 20 minutes.
#
# Environment (paths relative to the repository root): RUN (default
# runs/mt3_flagship_torch), CORPUS (default corpus), STEPS (12000),
# EVAL_PERIOD (1000), MAX_RESTARTS (40), PYTHON (python3).
#
# Usage: setsid nohup bash mt3_tpu_torch/tools/run_flagship.sh \
#            >> runs/mt3_flagship_torch/wrapper.log 2>&1 &

cd "$(dirname "$0")/../.." || exit 1
RUN=${RUN:-runs/mt3_flagship_torch}
CORPUS=${CORPUS:-corpus}
LOG=$RUN/train.log
STEPS=${STEPS:-12000}
EVAL_PERIOD=${EVAL_PERIOD:-1000}
MAX_RESTARTS=${MAX_RESTARTS:-40}
PYTHON=${PYTHON:-python3}
mkdir -p "$RUN"

restarts=0
while [ $restarts -lt $MAX_RESTARTS ]; do
  "$PYTHON" -m mt3_tpu_torch.cli.train --model mt3 \
    --data polysynth:16384:1000 --cache_dir "$CORPUS/cache" \
    --eval_data "$CORPUS/validation" --eval_examples 24 \
    --eval_period "$EVAL_PERIOD" \
    --steps "$STEPS" --batch_size 256 --remat --attention flash --bf16 \
    --preload_cache --checkpoint_dir "$RUN/ckpt" --checkpoint_period 1000 \
    --log_dir "$RUN/logs" --log_every 20 --resume --exit_rss_gb 70 \
    >> "$LOG" 2>&1 &
  PID=$!
  echo "$(date -u +%FT%TZ) launched trainer pid $PID (restart $restarts)"
  echo $PID > "$RUN/train.pid"

  while kill -0 $PID 2>/dev/null; do
    sleep 5
    if [ -f "$LOG" ]; then
      stale=$(( $(date +%s) - $(stat -c %Y "$LOG") ))
      if [ $stale -gt 1200 ]; then
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
