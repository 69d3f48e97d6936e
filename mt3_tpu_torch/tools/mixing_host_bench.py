"""Host-pipeline throughput for the pretrain-style mixing path (CPU only;
port of tools/mixing_host_bench.py on the port's pipeline, with its flags
and printed line).

The mixing probe (mt3_tpu_torch/tools/run_mixing_probe.sh) proves the
device side; this
measures the other half on the single host core: segment decode -> random
crop -> k-way mix (audio sum + RLE merge, reference mixing.py:29-91 /
gin/ismir2022/pretrain.gin MAX_EXAMPLES_PER_MIX=8) -> finalize -> batch.
If host batches/s exceeds the device steps/s at the same batch size, the
pipeline is not the training bottleneck even un-prefetched.

Runs entirely on the host CPU and touches no device.

Usage:
  python -m mt3_tpu_torch.tools.mixing_host_bench --batch 256 --mix 8
"""

import argparse
import time


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--cache', default='corpus/cache')
  parser.add_argument('--batch', type=int, default=256)
  parser.add_argument('--mix', type=int, default=8)
  parser.add_argument('--batches', type=int, default=20)
  parser.add_argument('--preload', action='store_true',
                      help='preload segments (the probe uses '
                           '--preload_cache); default streams, which '
                           'includes record decode = conservative')
  args = parser.parse_args(argv)

  from mt3_tpu_torch.core import config as config_lib
  from mt3_tpu_torch.data import pipeline
  from mt3_tpu_torch.codec import vocabulary

  config = config_lib.mt3_config()
  run = config.run
  codec = vocabulary.build_codec(config.vocab)
  vocab = vocabulary.vocabulary_from_codec(codec)
  cfg = pipeline.TrainPipelineConfig(
      inputs_length=run.inputs_length, targets_length=run.targets_length,
      batch_size=args.batch, onsets_only=run.onsets_only,
      include_ties=run.use_ties,
      program_granularity=run.program_granularity,
      max_examples_per_mix=args.mix or None, seed=0)

  it = pipeline.train_batches_from_cache(
      args.cache, codec, vocab, cfg, preload=args.preload)
  next(it)  # warmup: stream/preload spin-up excluded from the rate
  t0 = time.perf_counter()
  for _ in range(args.batches):
    batch = next(it)
  dt = time.perf_counter() - t0
  bps = args.batches / dt
  print(f'mix<={args.mix} batch={args.batch} preload={args.preload}: '
        f'{bps:.3f} batches/s = {bps * args.batch:.0f} examples/s '
        f'({dt / args.batches * 1e3:.0f} ms/batch)', flush=True)


if __name__ == '__main__':
  main()
