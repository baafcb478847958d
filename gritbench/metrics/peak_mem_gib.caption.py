"""``max_memory_allocated`` over set-up and the window of caption batches,
in GiB: memory bounds the batch a card holds."""

from gritbench.readers import peak_mem_gib as read  # noqa: F401
