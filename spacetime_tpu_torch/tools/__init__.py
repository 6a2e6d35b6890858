"""Measurement scripts of the port, run on the card (``python -m
spacetime_tpu_torch.tools.<name>``)."""
