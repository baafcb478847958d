"""Inputs that every traffic driver makes the same way: uint8 image batches
drawn on the card from a generator, each image top-left in the bucket
(cycling through the mix's ``image_sizes``), zero and masked beyond it, and
kept in host memory (pinned when there is a card) so that each batch is
copied to the card inside the window, as a loader's batch is."""

from __future__ import annotations

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a run's inputs."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % 2 ** 63)


def images(traffic: dict, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(uint8 [B, H, W, 3], pad mask [B, H, W]) of one batch on ``device``."""
    b, (bh, bw) = traffic["batch"], traffic["bucket"]
    imgs = torch.randint(0, 256, (b, bh, bw, 3), dtype=torch.uint8, generator=gen, device=device)
    pad = torch.ones((b, bh, bw), dtype=torch.bool, device=device)
    for i in range(b):
        h, w = traffic["image_sizes"][i % len(traffic["image_sizes"])]
        pad[i, :h, :w] = False
    return imgs.masked_fill_(pad[..., None], 0), pad


def to_host(batch: dict) -> dict:
    """The batch's tensors in host memory, pinned when they came from a card."""
    return {k: v.cpu().pin_memory() if v.is_cuda else v.cpu() for k, v in batch.items()}
