"""repro_torch.training — so far only the metrics logger the launch
CLIs share (a copy of ``repro/training/metrics.py``); the trainer, loop,
optimisers and checkpoints come with the sharded LM trainer."""
