"""repro_torch.data — the synthetic token batches of the LM trainer (a
numpy copy of ``repro/data/synthetic.py``)."""
from repro_torch.data.synthetic import DataConfig, make_batch, token_batches

__all__ = ["DataConfig", "make_batch", "token_batches"]
