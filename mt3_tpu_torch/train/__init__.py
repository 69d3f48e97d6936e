"""Training: losses, Adafactor, the train step and Trainer, checkpoints."""
