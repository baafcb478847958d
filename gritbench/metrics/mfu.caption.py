"""Model operations of the caption batches (``gritbench/counts/caption.py``)
over the traced run's window, as a share of the card's bf16 peak."""

from gritbench.readers import mfu_percent as read  # noqa: F401
