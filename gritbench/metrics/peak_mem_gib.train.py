"""``max_memory_allocated`` over the window of training steps, in GiB:
memory bounds the batch a card holds."""

from gritbench.readers import peak_mem_gib as read  # noqa: F401
