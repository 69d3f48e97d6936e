"""Kernel B's share of its roofline over the traced decode steps, in %.

The least time the decode self-attention of every traced step needs (each
of the decoder's layers at each step's cache index: the live prefix of
both caches, q, out, the new K/V and the written column, work.b_variant_
bytes, against 3.35 TB/s: bytes bound it at every index of these cells)
over the device time of the kernels named below in those steps.  The
cache's bits (counter kv_bits: None for a float cache, else 8 or 4 with
float32 scales) and the activations' width (elt) are those of the port's
configuration as the cell runs it.  Moves audio_s_per_s."""

from gpubench import work

KERNELS = ('decode_attention_split_kernel', 'decode_attention_grouped_')


def read(r):
  session = r.sessions.get('decode')
  indices = r.counters.get('decode_indices', [])
  if session is None or not indices:
    return None
  device_s = session.device_s(lambda n: any(k in n for k in KERNELS))
  if device_s <= 0:
    return None
  m = r.config['model']
  kv = m.get('num_kv_heads') or m['num_heads']
  least_ms = sum(
      work.bound(0.0, work.b_variant_bytes(
          r.counters['rows'], kv, m['num_heads'], m['head_dim'], index,
          r.counters['kv_bits'], r.counters['elt']))[0]
      for index in indices) * m['num_decoder_layers']
  return 100.0 * least_ms / (device_s * 1e3)
