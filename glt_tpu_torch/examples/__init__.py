"""Runnable examples of the port (``python -m glt_tpu_torch.examples.<name>``)."""
