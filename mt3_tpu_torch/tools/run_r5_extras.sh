#!/bin/bash
# The round-5 extras on the port (counterpart of tools/run_r5_extras.sh,
# with the same steps and flags), run only after
# mt3_tpu_torch/tools/run_r5_queue.sh has printed QUEUE COMPLETE into the
# same $RUN/queue.log: flash against plain attention at the ismir2021
# 512-frame training length, then the default bench once.
#
# The step / done-marker / queue.log mechanics are the queue's.  The JAX
# script's TPU health concerns do not apply on a CUDA host.
#
# Environment (paths relative to the repository root): RUN (default
# runs/r5_queue_torch), WAIT_MINUTES (how long to wait for the queue,
# default 600), PYTHON (python3).
#
# Usage: setsid nohup bash mt3_tpu_torch/tools/run_r5_extras.sh \
#            > runs/r5_queue_torch/extras_wrapper.log 2>&1 &

cd "$(dirname "$0")/../.." || exit 1
RUN=${RUN:-runs/r5_queue_torch}
WAIT_MINUTES=${WAIT_MINUTES:-600}
PYTHON=${PYTHON:-python3}
mkdir -p "$RUN"
LOG=$RUN/queue.log
say() { echo "$(date -u +%FT%TZ) $*" | tee -a "$LOG"; }

# Wait for the main queue to finish; never overlap two jobs on the card.
for i in $(seq 1 "$WAIT_MINUTES"); do
  grep -q "QUEUE COMPLETE" "$LOG" 2>/dev/null && break
  sleep 60
done
grep -q "QUEUE COMPLETE" "$LOG" || {
  say "extras: main queue never completed; aborting"; exit 1; }

step() {
  local name=$1; shift
  if [ -f "$RUN/done.$name" ]; then say "SKIP $name (done)"; return; fi
  say "START $name: $*"
  "$@" >> "$RUN/$name.log" 2>&1
  local rc=$?
  say "END $name rc=$rc"
  [ $rc -eq 0 ] && touch "$RUN/done.$name"
}

step i21_xla "$PYTHON" -m mt3_tpu_torch.tools.train_bench \
  --model ismir2021 --batch 64 --bf16 --remat
step i21_flash "$PYTHON" -m mt3_tpu_torch.tools.train_bench \
  --model ismir2021 --batch 64 --bf16 --remat --flash
step bench_warm "$PYTHON" -m mt3_tpu_torch.bench

say "EXTRAS COMPLETE"
