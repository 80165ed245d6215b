"""Training of the port: the optimizer (``train/optimizer.py``) and the
train step (``train/train_step.py``)."""
