"""Feature-extraction tools of the port (``python -m grit_tpu_torch.tools.<name>``)."""
