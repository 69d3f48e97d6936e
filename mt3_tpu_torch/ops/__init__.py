"""The port's device operations: kernels A (logmel), B (decode_attention)
and C (flash_attention), each beside its plain version."""


def launch_counts() -> dict:
  """This process's kernel launches so far: kernel A, kernel B by cache
  variant ('decode_attention_mha', '_gqa', '_int8', '_int4', '_int8_gqa',
  '_int4_gqa') and kernel C by entry point."""
  from mt3_tpu_torch.ops import decode_attention, flash_attention, logmel
  return {'logmel': logmel.LAUNCHES,
          **{f'decode_attention_{k}': v
             for k, v in sorted(decode_attention.VARIANT_LAUNCHES.items())},
          **{f'flash_attention_{k}': v
             for k, v in flash_attention.LAUNCHES.items()}}
