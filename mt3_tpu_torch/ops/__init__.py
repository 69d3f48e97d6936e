"""The port's device operations: kernels A (logmel), B (decode_attention),
C (flash_attention), D (rms_norm) and E (dropout), each beside its plain
version."""

from mt3_tpu_torch.ops import cuda_build

# launch_counts()' names that read 0 before their first launch; kernel B's
# ('decode_attention_<variant>', ops/decode_attention.variant) appear as
# they launch.
KERNELS = ('logmel',
           *(f'flash_attention_{route}{which}' for route in ('', 'f32_')
             for which in ('fwd', 'dkv', 'dq')),
           'rms_norm_fwd', 'rms_norm_bwd', 'dropout_add_fwd',
           'dropout_add_bwd')


def launch_counts() -> dict:
  """This process's kernel launches since the last reset_launches(), by
  name (ops/cuda_build.LAUNCHES): kernel A, kernel B by cache variant
  ('decode_attention_mha', '_gqa', '_int8', '_int4', '_int8_gqa',
  '_int4_gqa'), kernel C by route and entry point ('flash_attention_fwd',
  '_dkv', '_dq' in bfloat16, 'flash_attention_f32_*' in float32), kernel
  D ('rms_norm_fwd'; 'rms_norm_bwd', one for its two kernels) and kernel
  E ('dropout_add_fwd', 'dropout_add_bwd')."""
  return dict(sorted({**dict.fromkeys(KERNELS, 0),
                      **cuda_build.LAUNCHES}.items()))


def reset_launches() -> None:
  """Zeroes launch_counts()."""
  cuda_build.LAUNCHES.clear()
