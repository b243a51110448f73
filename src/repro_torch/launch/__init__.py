"""repro_torch.launch — the port's command-line entry points
(``python -m repro_torch.launch.async_train``)."""
