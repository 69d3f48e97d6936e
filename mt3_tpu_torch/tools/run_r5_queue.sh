#!/bin/bash
# The round-5 measurement queue on the port (counterpart of
# tools/run_r5_queue.sh, with the same steps and flags).
#
# Each step is a fresh python process running one of the port's
# measurement tools; progress and results append to $RUN/queue.log, each
# step's output to $RUN/<step>.log.  A step that exits 0 leaves a done
# marker ($RUN/done.<step>) and is skipped when the queue runs again; a
# step that fails is recorded and the queue continues (the measurements
# are independent).  The JAX script's TPU health probes (a wait for the
# chip after a wedge, and a check after the risky steps) are left out:
# they wait out a TPU runtime fault and mean nothing on a CUDA host.
#
# Environment (paths relative to the repository root): RUN (default
# runs/r5_queue_torch), CORPUS (default corpus), PROFILE (the trace
# directory of bw_profile, default $RUN/prof), PYTHON (python3).
#
# Usage: setsid nohup bash mt3_tpu_torch/tools/run_r5_queue.sh \
#            > runs/r5_queue_torch/wrapper.log 2>&1 &

cd "$(dirname "$0")/../.." || exit 1
RUN=${RUN:-runs/r5_queue_torch}
CORPUS=${CORPUS:-corpus}
PROFILE=${PROFILE:-$RUN/prof}
PYTHON=${PYTHON:-python3}
mkdir -p "$RUN"
LOG=$RUN/queue.log

say() { echo "$(date -u +%FT%TZ) $*" | tee -a "$LOG"; }

step() {
  local name=$1; shift
  if [ -f "$RUN/done.$name" ]; then say "SKIP $name (done)"; return; fi
  say "START $name: $*"
  "$@" >> "$RUN/$name.log" 2>&1
  local rc=$?
  say "END $name rc=$rc"
  [ $rc -eq 0 ] && touch "$RUN/done.$name"
}

# 1. Trained-weights bench: throughput with EOS early exit on real corpus
#    audio, against the forbid_eos worst case.
step trained_bench "$PYTHON" -m mt3_tpu_torch.bench \
  --checkpoint runs/gqa_ft_torch/ckpt --audio "$CORPUS/test"

# 2. Bandwidth accounting: profile the production configuration, fit the
#    step time against the cache index, and run the residual-attribution
#    patterns.
step bw_profile "$PYTHON" -m mt3_tpu_torch.tools.perf_experiments \
  --variant int4_cross_gqa1 --batch 1024 --steps_per_iter 16 \
  --cache_carry stacked --profile "$PROFILE"
step bw_fit "$PYTHON" -m mt3_tpu_torch.tools.bucket_fit "$PROFILE" \
  --batch 1024 --spi 16 --kv_heads 1
step bw_patterns "$PYTHON" -m mt3_tpu_torch.tools.cache_bw_bench \
  --patterns masked,written,interleaved --batch 1024

# 3. Beam cost: greedy at the same batch and variant for the ratio, then
#    2 and 4 beams.
step beam_g8 "$PYTHON" -m mt3_tpu_torch.tools.perf_experiments \
  --variant int8_cross --batch 256 --steps_per_iter 16 --cache_carry stacked
step beam2_8 "$PYTHON" -m mt3_tpu_torch.tools.perf_experiments \
  --variant int8_cross --batch 256 --num_beams 2
step beam4_8 "$PYTHON" -m mt3_tpu_torch.tools.perf_experiments \
  --variant int8_cross --batch 256 --num_beams 4

# 4. Mixing probe: a 500-step pretrain-style mix<=8 training segment.
step mixing env RUN="$RUN/mixing_probe" CORPUS="$CORPUS" PYTHON="$PYTHON" \
  bash mt3_tpu_torch/tools/run_mixing_probe.sh

# 5. Beams over int4 caches.
step beam2_4 "$PYTHON" -m mt3_tpu_torch.tools.perf_experiments \
  --variant int4_cross --batch 256 --num_beams 2
step beam4_4 "$PYTHON" -m mt3_tpu_torch.tools.perf_experiments \
  --variant int4_cross --batch 256 --num_beams 4

say "QUEUE COMPLETE"
