"""Multi-device execution: the ('data', 'model') mesh on torch.distributed."""
