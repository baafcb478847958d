"""Plain float32 reference of GRIT's detector pre-training step: the
detection heads of every decoder level, the set criterion with its
Hungarian matching (scipy's solver on the host), the global-norm clip and
the five-group AdamW with decoupled decay.

Written from Deformable DETR (arXiv 2010.04159: box refinement, auxiliary
losses, the sigmoid focal loss and the matching cost of focal class cost,
L1 and GIoU) and the recipe of davidnvq/grit
``configs/detection/train_config.yaml`` (five AdamW groups: heads and
decoder at ``lr``, the backbone at ``lr_backbone``, no decay on biases and
vectors; clip 0.1).  Dropout and drop-path masks are drawn from a generator
the caller hands in, in the order the model's layers run, so that a step
seeded alike draws the same masks.

The step is written over data-parallel ranks (``global_steps``): each
rank's share is run with its own masks, its loss normalised by the box
count of the whole global batch, and the shares' gradients summed before
the one clip and the optimizer's step.  One card is the step of one rank.
"""

from __future__ import annotations

import torch
from scipy.optimize import linear_sum_assignment

from gritbench.reference import vision
from gritbench.reference.nn import Arith, dense


class Masks:
    """Dropout and drop-path from one generator: ``x / (1 - p)`` where a
    uniform draw is at least ``p``, 0 elsewhere."""

    def __init__(self, generator, p: float):
        self.gen, self.p = generator, p

    def dropout(self, x):
        if self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=self.gen) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)

    def keeps(self, batch: int, rate: float, device):
        if rate == 0.0:
            return None
        return tuple(torch.rand(batch, device=device, generator=self.gen) >= rate
                     for _ in range(2))


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(a, b):
    """Pairwise generalised IoU of xyxy boxes [N, 4] x [M, 4] -> [N, M]."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / union
    lt = torch.min(a[:, None, :2], b[None, :, :2])
    rb = torch.max(a[:, None, 2:], b[None, :, 2:])
    hull = (rb - lt).clamp(min=0).prod(-1)
    return iou - (hull - union) / hull


def heads(A: Arith, P, hs, refs):
    """Class logits and boxes of every level [L, B, Q, ...]: level l adds its
    box head's output to the logit of the boxes it refines (the initial
    boxes for levels 0 and 1, then each layer's)."""
    dm = "det_module"
    logits, boxes = [], []
    for lvl in range(hs.shape[0]):
        ref = refs[0] if lvl == 0 else refs[lvl - 1]
        tmp = vision.box_mlp(A, P, f"{dm}.bbox_embed.{lvl}", hs[lvl])
        boxes.append(torch.sigmoid(tmp + vision.inverse_sigmoid(ref)))
        logits.append(dense(A, hs[lvl], P, f"{dm}.class_embed.{lvl}"))
    return torch.stack(logits), torch.stack(boxes)


def focal(logits, target, alpha: float = 0.25):
    prob = torch.sigmoid(logits)
    ce = torch.nn.functional.binary_cross_entropy_with_logits(logits, target, reduction="none")
    p_t = prob * target + (1 - prob) * (1 - target)
    return (alpha * target + (1 - alpha) * (1 - target)) * ce * (1 - p_t) ** 2


def match(logits, boxes, labels, tgt_boxes, cost: dict):
    """Hungarian assignment of one image's n boxes -> the query of each box."""
    with torch.no_grad():
        prob = torch.sigmoid(logits[:, labels])                       # [Q, n]
        neg = 0.75 * prob ** 2 * -torch.log(1 - prob + 1e-8)
        pos = 0.25 * (1 - prob) ** 2 * -torch.log(prob + 1e-8)
        c = (cost["bbox"] * torch.cdist(boxes, tgt_boxes, p=1) + cost["class"] * (pos - neg)
             - cost["giou"] * giou(cxcywh_to_xyxy(boxes), cxcywh_to_xyxy(tgt_boxes)))
        rows, cols = linear_sum_assignment(c.double().cpu().numpy())
    out = torch.empty(len(cols), dtype=torch.long)
    out[torch.from_numpy(cols)] = torch.from_numpy(rows)
    return out.to(logits.device)


def criterion(logits, boxes, targets: dict, cfg: dict, rows: int | None = None):
    """Weighted sum of the focal, L1 and GIoU losses of every level, each
    normalised by the box count of the images it covers (the first ``rows``,
    default all) -> (loss, the assignments [L, images] as lists)."""
    w = cfg["loss_weights"]
    cost = cfg["match_cost"]
    rows = logits.shape[1] if rows is None else rows
    logits, boxes = logits[:, :rows], boxes[:, :rows]
    valid = targets["valid"][:rows]
    num = valid.sum().float().clamp(min=1.0)
    total = 0.0
    assigns = []
    for lvl in range(logits.shape[0]):
        lv = []
        onehot = torch.zeros_like(logits[lvl])
        l1 = gi = 0.0
        for b in range(logits.shape[1]):
            n = int(valid[b].sum())
            labels = targets["labels"][b, :n].long()
            tgt = targets["boxes"][b, :n].float()
            q = match(logits[lvl, b], boxes[lvl, b], labels, tgt, cost)
            lv.append(q)
            onehot[b, q, labels] = 1.0
            src = boxes[lvl, b, q]
            l1 = l1 + (src - tgt).abs().sum()
            gi = gi + (1 - torch.diagonal(giou(cxcywh_to_xyxy(src), cxcywh_to_xyxy(tgt)))).sum()
        ce = focal(logits[lvl], onehot).sum()
        total = total + (w["ce"] * ce + w["bbox"] * l1 + w["giou"] * gi) / num
        assigns.append(lv)
    return total, assigns


def param_group(name: str, shape, opt: dict) -> tuple[float, float]:
    """(learning rate, weight decay) of a parameter in the recipe's groups."""
    no_decay = len(shape) <= 1 or name.endswith(".bias")
    lr = opt["lr_backbone"] if "backbone" in name else opt["lr"]
    return lr, 0.0 if no_decay else opt["weight_decay"]


class AdamW:
    """Adam with decoupled weight decay: p -= lr (m_hat / (sqrt(v_hat) + eps)
    + wd p), bias-corrected moments."""

    def __init__(self, params: dict, opt: dict):
        self.params, self.opt = params, opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        b1, b2, eps = self.opt["beta1"], self.opt["beta2"], self.opt["eps"]
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            lr, wd = param_group(k, p.shape, self.opt)
            p.sub_(lr * (m_hat / (v_hat.sqrt() + eps) + wd * p))


def share_loss(A: Arith, params: dict, share, cfg: dict, masks: Masks, boxes_global: float,
               half: bool = False):
    """One rank's share of the global loss: its batch's weighted losses
    normalised by the box count of the whole global batch.  ``half``: the
    fault of a loss that leaves out half of the batch (the global count is
    then of the halves)."""
    images, pad, targets = share
    m = cfg["model"]
    keeps = [masks.keeps(images.shape[0], r, images.device)
             for r in vision.drop_path_rates(m["swin"])]
    hs, refs, _, _ = vision.detector(A, params, "", images, pad,
                                     {"swin": m["swin"], "detector": m["detector"]},
                                     keeps=keeps, dropout=masks.dropout)
    logits, boxes = heads(A, params, hs, refs)
    rows = images.shape[0] // 2 if half else images.shape[0]
    loss, _ = criterion(logits, boxes, targets, cfg, rows)
    # ``criterion`` normalises by this share's own count
    own = float(targets["valid"][:rows].sum().clamp(min=1))
    return loss * (own / boxes_global)


def global_steps(A: Arith, P0: dict, steps, cfg: dict, mask_seeds: list[int], device,
                 leave_out: int | None = None, half: bool = False) -> dict:
    """``len(steps)`` training steps from the weights ``P0`` over
    ``len(mask_seeds)`` data-parallel ranks, one rank's share at a time;
    ``steps[i][r]`` is rank r's (images, pad, targets) at step i and
    ``mask_seeds[r]`` seeds its masks.  The shares' gradients are summed, as
    data parallel's mean of the ranks' world-scaled gradients is, then
    clipped on their global norm -> {"loss" [steps] (summed over the
    shares), "grad_norm" [steps] (before the clip), "first_grad" {name: the
    clipped gradient of step 1}, "params" (after the last step)}.

    Planted faults: ``leave_out`` = r, the mean over the ranks taken without
    rank r's gradient (the others' world-scaled gradients averaged over
    ``world - 1``); ``half``, every rank's loss over half of its batch, its
    mean taken over the rest."""
    world = len(mask_seeds)
    p = cfg["model"]["detector"]["dropout"]
    masks = [Masks(torch.Generator(device=device).manual_seed(int(s)), p) for s in mask_seeds]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    names = list(params)
    opt = AdamW(params, cfg["optimizer"])
    rows = (lambda t: t[: t.shape[0] // 2]) if half else (lambda t: t)
    out = {"loss": [], "grad_norm": []}
    for i, shares in enumerate(steps):
        boxes_global = max(1.0, sum(float(rows(t["valid"]).sum()) for _, _, t in shares))
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for r, share in enumerate(shares):
            loss = share_loss(A, params, share, cfg, masks[r], boxes_global, half)
            got = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
            if r != leave_out:
                with torch.no_grad():
                    for k, g in zip(names, got):
                        if g is not None:
                            grads[k] += g
            total += float(loss.detach())
            del loss, got
        if leave_out is not None:
            grads = {k: g * (world / (world - 1)) for k, g in grads.items()}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        clip = cfg["optimizer"]["clip_max_norm"]
        scale = min(1.0, clip / (float(norm) + 1e-6)) if clip else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        if i == 0:
            out["first_grad"] = {k: g.detach() for k, g in grads.items()}
        opt.step(grads)
        out["loss"].append(total)
        out["grad_norm"].append(float(norm))
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out


def train_steps(A: Arith, P0: dict, batches, cfg: dict, seed_masks: int, device,
                half: bool = False) -> dict:
    """``len(batches)`` training steps on one card: ``global_steps`` with one
    rank, whose share at step i is ``batches[i]``."""
    return global_steps(A, P0, [[b] for b in batches], cfg, [seed_masks], device, half=half)
