#!/bin/bash
# Pretrain-style mixing probe on the card (counterpart of
# tools/run_mixing_probe.sh, with the same train CLI flags).
#
# The reference pretrain recipe mixes 1..8 random examples per training
# example (gin/ismir2022/pretrain.gin:3-10 -> mixing.py:29-91).  This
# probe runs a short training segment of mt3 at batch 256, remat, bf16
# flash attention, through the port's train CLI with
# --max_examples_per_mix 8, to show that the k-way RLE merge and the
# waveform mix keep the host pipeline up with the card (loss decreasing,
# no stall).
#
# Environment (paths relative to the repository root): RUN (default
# runs/mixing_probe_torch), CORPUS (default corpus; its segment cache is
# CORPUS/cache), STEPS (500), PYTHON (python3).
#
# Usage: setsid nohup bash mt3_tpu_torch/tools/run_mixing_probe.sh \
#            >> runs/mixing_probe_torch/wrapper.log 2>&1 &

cd "$(dirname "$0")/../.." || exit 1
RUN=${RUN:-runs/mixing_probe_torch}
CORPUS=${CORPUS:-corpus}
STEPS=${STEPS:-500}
PYTHON=${PYTHON:-python3}
mkdir -p "$RUN"

"$PYTHON" -m mt3_tpu_torch.cli.train --model mt3 \
  --data polysynth:16384:1000 --cache_dir "$CORPUS/cache" \
  --steps "$STEPS" --batch_size 256 --remat --attention flash --bf16 \
  --preload_cache --max_examples_per_mix 8 \
  --checkpoint_dir "$RUN/ckpt" --checkpoint_period 500 \
  --log_dir "$RUN/logs" --log_every 20 --exit_rss_gb 70 \
  >> "$RUN/train.log" 2>&1
code=$?
echo "$(date -u +%FT%TZ) mixing probe exited code $code"
exit $code
