"""The device's idle share over the traced train steps, in %: 1 minus
the union of every device operation's interval (kernels, copies, sets)
inside the traced window, over that window's own wall time.  Moves
train_tokens_per_s."""


def read(r):
  session = r.sessions.get('train')
  if session is None or session.window_s <= 0:
    return None
  return 100.0 * (1.0 - session.busy_s / session.window_s)
