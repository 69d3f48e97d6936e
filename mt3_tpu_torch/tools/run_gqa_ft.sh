#!/bin/bash
# GQA recovery finetune for the PyTorch port (counterpart of
# tools/run_gqa_ft.sh, with the same train CLI flags).
#
# Warm-starts from the flagship MHA checkpoint, mean-pools the 6 KV heads
# to 1 (params.convert_mha_to_gqa), and finetunes on the same corpus so the
# GQA decode configuration is quality-legal.  Gate afterwards with:
#   python -m mt3_tpu_torch.tools.quality_gates \
#     --checkpoint runs/mt3_flagship_torch/ckpt --data corpus/test --num 24 \
#     --gqa --gqa_checkpoint runs/gqa_ft_torch/ckpt
#
# As in run_flagship.sh the trainer exits 75 at --exit_rss_gb and the loop
# relaunches it with --resume (which takes precedence over --init_from once
# a GQA checkpoint exists, so finetune progress is never discarded), and a
# watchdog relaunches it when its log goes stale for 20 minutes.  The JAX
# script's second watchdog, which kills a process that stays under 1.2 GB
# of resident memory after 18 minutes, is left out: it caught a hang at
# TPU initialisation that a CUDA host does not have.
#
# Environment (paths relative to the repository root): RUN (default
# runs/gqa_ft_torch), CORPUS (default corpus), TEACHER (default
# runs/mt3_flagship_torch/ckpt), STEPS (5000), EVAL_PERIOD (500),
# MAX_RESTARTS (20), PYTHON (python3).
#
# Usage: setsid nohup bash mt3_tpu_torch/tools/run_gqa_ft.sh \
#            >> runs/gqa_ft_torch/wrapper.log 2>&1 &

cd "$(dirname "$0")/../.." || exit 1
RUN=${RUN:-runs/gqa_ft_torch}
CORPUS=${CORPUS:-corpus}
LOG=$RUN/train.log
STEPS=${STEPS:-5000}
TEACHER=${TEACHER:-runs/mt3_flagship_torch/ckpt}
EVAL_PERIOD=${EVAL_PERIOD:-500}
MAX_RESTARTS=${MAX_RESTARTS:-20}
PYTHON=${PYTHON:-python3}
mkdir -p "$RUN"

restarts=0
while [ $restarts -lt $MAX_RESTARTS ]; do
  "$PYTHON" -m mt3_tpu_torch.cli.train --model mt3 \
    --data polysynth:16384:1000 --cache_dir "$CORPUS/cache" \
    --eval_data "$CORPUS/validation" --eval_examples 24 \
    --eval_period "$EVAL_PERIOD" \
    --steps "$STEPS" --batch_size 256 --remat --attention flash --bf16 \
    --preload_cache --init_from "$TEACHER" --gqa_kv_heads 1 \
    --lr 5e-4 --checkpoint_dir "$RUN/ckpt" --checkpoint_period 500 \
    --log_dir "$RUN/logs" --log_every 20 --resume --exit_rss_gb 70 \
    >> "$LOG" 2>&1 &
  PID=$!
  echo "$(date -u +%FT%TZ) launched gqa finetune pid $PID (restart $restarts)"
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
  echo "$(date -u +%FT%TZ) gqa finetune exited code $code"
  if [ $code -eq 0 ]; then
    echo "$(date -u +%FT%TZ) finetune complete"
    exit 0
  fi
  restarts=$((restarts + 1))
  sleep 15
done
echo "$(date -u +%FT%TZ) giving up after $MAX_RESTARTS restarts"
exit 1
