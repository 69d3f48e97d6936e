"""The dropout keep masks of one training step, drawn anew from the seed.

MT3 trains with dropout 0.1.  The masks are random draws, so the
reference can only follow the program's step by drawing the same ones.
It draws them here from the run's seed and the step number by the scheme
the program states (one host generator per step from the seed sequence
(seed, step); from it one 62-bit seed per encoder site and per layer,
then the decoder's; on the compute device one generator per site from
that seed; keep = uniform < 1 - rate), at the global batch, in the order
a teacher-forced forward pass reaches them.  Nothing the program made is
read.

Sites: 'enc.in' [b, 1, emb]; per encoder layer l 'enc.l.attn' [b, h, 1,
frames], 'enc.l.res1' [b, 1, emb], 'enc.l.mlp' [b, 1, mlp], 'enc.l.res2';
'enc.out' [b, frames, emb]; 'dec.in' [b, 1, emb]; per decoder layer
'dec.l.self' [b, h, 1, T], 'dec.l.res1', 'dec.l.cross' [b, h, 1, frames],
'dec.l.res2', 'dec.l.mlp' [b, 1, mlp], 'dec.l.res3'; 'dec.out' [b, 1, emb].
"""

from __future__ import annotations

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
  words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
  return torch.Generator().manual_seed(
      (int(words[0]) << 32 | int(words[1])) & (2**63 - 1))


def _keep(seed, rate, device):
  gen = torch.Generator(device=device).manual_seed(seed)
  return lambda *s: torch.rand(s, generator=gen, device=device) < 1.0 - rate


def draw(cfg, seed, step, batch, frames, targets, device):
  rate = cfg['dropout_rate']
  h, emb, mlp = cfg['num_heads'], cfg['emb_dim'], cfg['mlp_dim']
  host = step_generator(seed, step)
  n_enc, n_dec = cfg['num_encoder_layers'], cfg['num_decoder_layers']
  enc = torch.randint(0, 2**62, (2 + n_enc,), generator=host).tolist()
  dec = torch.randint(0, 2**62, (2 + n_dec,), generator=host).tolist()
  masks = {'enc.in': _keep(enc[0], rate, device)(batch, 1, emb)}
  for l in range(n_enc):
    keep = _keep(enc[2 + l], rate, device)
    masks[f'enc.{l}.attn'] = keep(batch, h, 1, frames)
    masks[f'enc.{l}.res1'] = keep(batch, 1, emb)
    masks[f'enc.{l}.mlp'] = keep(batch, 1, mlp)
    masks[f'enc.{l}.res2'] = keep(batch, 1, emb)
  masks['enc.out'] = _keep(enc[1], rate, device)(batch, frames, emb)
  masks['dec.in'] = _keep(dec[0], rate, device)(batch, 1, emb)
  for l in range(n_dec):
    keep = _keep(dec[2 + l], rate, device)
    masks[f'dec.{l}.self'] = keep(batch, h, 1, targets)
    masks[f'dec.{l}.res1'] = keep(batch, 1, emb)
    masks[f'dec.{l}.cross'] = keep(batch, h, 1, frames)
    masks[f'dec.{l}.res2'] = keep(batch, 1, emb)
    masks[f'dec.{l}.mlp'] = keep(batch, 1, mlp)
    masks[f'dec.{l}.res3'] = keep(batch, 1, emb)
  masks['dec.out'] = _keep(dec[1], rate, device)(batch, 1, emb)
  return masks


def rows(masks, start, stop):
  return {k: v[start:stop] for k, v in masks.items()}
