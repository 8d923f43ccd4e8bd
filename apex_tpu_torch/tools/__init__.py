"""Measurement scripts of the port (``python -m apex_tpu_torch.tools.<name>``)."""
