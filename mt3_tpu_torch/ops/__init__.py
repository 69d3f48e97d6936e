"""The port's device operations: kernels A (logmel), B (decode_attention),
C (flash_attention) and D (rms_norm), each beside its plain version."""


def launch_counts() -> dict:
  """This process's kernel launches so far: kernel A, kernel B by cache
  variant ('decode_attention_mha', '_gqa', '_int8', '_int4', '_int8_gqa',
  '_int4_gqa'), kernel C by entry point and kernel D ('rms_norm_fwd',
  'rms_norm_bwd')."""
  from mt3_tpu_torch.ops import decode_attention, flash_attention, logmel
  from mt3_tpu_torch.ops import rms_norm
  return {'logmel': logmel.LAUNCHES,
          **{f'decode_attention_{k}': v
             for k, v in sorted(decode_attention.VARIANT_LAUNCHES.items())},
          **{f'flash_attention_{k}': v
             for k, v in flash_attention.LAUNCHES.items()},
          **{f'rms_norm_{k}': v for k, v in rms_norm.LAUNCHES.items()}}
