"""repro_torch.training — the sharded LM trainer of the port:
``trainer`` (Trainer, TrainState, the train step), ``loop`` (train),
``optim`` (the server optimizers), ``checkpoints`` (save and restore of
the train state) and ``metrics`` (the metrics logger the launch CLIs
share, a copy of ``repro/training/metrics.py``)."""
