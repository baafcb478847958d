"""Plain float32 reference of GRIT's cross-entropy (XE) training step: the
captioner's teacher-forced forward with its dropout and drop-path, the
token-mean negative log-likelihood, and Adam over two groups without weight
decay (the backbone group, every parameter under ``detector``, at a fixed
rate; the rest at the cosine schedule with its one-epoch linear warm-up,
davidnvq/grit ``utils/cap_scheduler.py``).  The position table and the
frozen Swin stages are not updated; parameters the step leaves without a
gradient are skipped.  Dropout and drop-path masks are drawn in the
model's order from a generator the caller seeds.
"""

from __future__ import annotations

import math

import torch

from gritbench.reference import caption, vision
from gritbench.reference.detection import Masks
from gritbench.reference.nn import Arith


def cosine_lr(step: int, s: dict) -> float:
    """The learning rate of the model group at ``step`` of the schedule."""
    its = s["num_its_per_epoch"]
    if step // its < 1:
        a = step / its
        return (s["init_lr"] - s["warmup_init_lr"]) * (0.1 * (1 - a) + a) + s["warmup_init_lr"]
    total = s["num_epochs"] * its
    return max(s["min_lr"],
               (s["init_lr"] - s["min_lr"]) * (1 + math.cos(math.pi * step / total)) / 2
               + s["min_lr"])


def frozen(name: str, stages: int) -> bool:
    """Whether the recipe freezes ``name``: the position table; with
    ``stages`` >= 0 the patch embedding, with ``stages`` >= 2 the Swin stages
    before ``stages - 1``."""
    if name.endswith("pos_emb.weight"):
        return True
    if "backbone" not in name:
        return False
    if stages >= 0 and "patch_embed" in name:
        return True
    return any(f".layers.{i}." in name for i in range(max(0, stages - 1)))


def train_steps(A: Arith, P0: dict, batches, cfg: dict, seed_masks: int, device,
                first_step: int = 1, half: bool = False) -> dict:
    """``len(batches)`` XE steps from ``P0`` on ``(images, pad, captions)``
    -> {"loss", "first_grad" {name: step 1's gradient}, "params"}.
    ``half``: the fault of a step whose loss leaves out half of the batch,
    its mean taken over the rest."""
    m = cfg["model"]
    opt = cfg["optimizer"]
    fs = m["frozen_stages"]
    params = {k: v.detach().clone().requires_grad_(not frozen(k, fs) or "pos_emb" in k)
              for k, v in P0.items()}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v), 0) for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(int(seed_masks))
    det_masks = Masks(gen, m["detector"]["dropout"])
    cap_masks = Masks(gen, m["dropout"])
    rates = vision.drop_path_rates(m["swin"])
    depths = m["swin"]["depths"]
    stage_of = [i for i, d in enumerate(depths) for _ in range(d)]
    out = {"loss": []}
    for i, (images, pad, captions) in enumerate(batches):
        keeps = [None if stage_of[j] < fs - 1 else det_masks.keeps(images.shape[0], r, device)
                 for j, r in enumerate(rates)]
        vis = vision.vision(A, params, images, pad, m, keeps, det_masks.dropout,
                            cap_masks.dropout)
        lp = caption.decoder_log_probs(A, params, captions, vis, m, cap_masks.dropout)
        rows = captions.shape[0] // 2 if half else captions.shape[0]
        tgt = captions[:rows, 1:]
        ll = torch.gather(lp[:rows, :-1], 2, tgt[..., None])[..., 0]
        real = (tgt != m["pad_idx"]).float()
        loss = -(ll * real).sum() / real.sum().clamp(min=1.0)
        names = [k for k, p in params.items() if p.requires_grad]
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: g for k, g in zip(names, grads) if g is not None and not frozen(k, fs)}
        if i == 0:
            out["first_grad"] = {k: g.detach() for k, g in grads.items()}
        lr_model = cosine_lr(first_step + i, opt["schedule"])
        b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
        with torch.no_grad():
            for k, g in grads.items():
                mu, nu, t = state[k]
                t += 1
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                state[k] = (mu, nu, t)
                lr = opt["backbone_lr"] if "detector" in k else lr_model
                params[k].sub_(lr * (mu / (1 - b1 ** t)) / ((nu / (1 - b2 ** t)).sqrt() + eps))
        out["loss"].append(float(loss.detach()))
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out
