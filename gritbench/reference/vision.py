"""Plain float32 reference of GRIT's vision stack: the Swin backbone (GRIT
flavour: every stage ends in a patch merge, the last one projecting to
``pos_dim``), the per-level input projections, the deformable decoder with
box refinement, and the grid feature network.

Written from the published descriptions (Swin: arXiv 2103.14030 and its
reference code's block, window and shift-mask conventions; Deformable DETR:
arXiv 2010.04159 with its PyTorch sampling core; GRIT: arXiv 2207.09666),
in evaluation mode: no dropout, no drop-path.  Weights are read from a dict
under the model's state-dict names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gritbench.reference.nn import (Arith, attention, dense, ffn, group_norm, identity,
                                    layer_norm, mha)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_u8: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32, ImageNet-normalised, zero where ``pad``."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    x = (images_u8.float() / 255.0 - mean) / std
    return x.masked_fill(pad[..., None], 0.0)


# ---------------------------------------------------------------- Swin


def rel_index(window: int, device) -> torch.Tensor:
    """[N, N] index into the (2w-1)^2 relative-position table."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    coords = torch.stack([ys.flatten(), xs.flatten()])            # [2, N]
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)  # [2, N, N]
    return (rel[0] * (2 * window - 1) + rel[1]).to(device)


def shift_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """[nW, N, N] additive mask of shifted windows: -100 between regions."""
    img = torch.zeros(hp, wp, device=device)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = partition(img[None, :, :, None], window)[..., 0]       # [nW, N]
    return (win[:, None, :] != win[:, :, None]).float() * -100.0


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def unpartition(x: torch.Tensor, window: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def window_attention(A: Arith, P, name: str, x, heads: int, window: int, mask):
    """x: windows [B*nW, N, C] -> [B*nW, N, C]."""
    bw, n, c = x.shape
    d = c // heads
    qkv = dense(A, x, P, name + ".qkv").reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    s = A.matmul(q, k.transpose(-1, -2))
    table = P[name + ".relative_position_bias_table"]
    idx = rel_index(window, x.device).reshape(-1)
    s = s + table[idx].reshape(n, n, heads).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]).reshape(bw, heads, n, n)
    o = A.matmul(torch.softmax(s, -1), v).transpose(1, 2).reshape(bw, n, c)
    return dense(A, o, P, name + ".proj")


def swin_block(A: Arith, P, name: str, x, heads: int, window: int, shift: int, keeps=None,
               rate: float = 0.0):
    """One Swin block on x [B, H, W, C]: pad after LN1 to window multiples,
    (shifted) window attention, crop, residual; then the MLP (exact GELU).
    ``keeps``: the two per-sample drop-path keep masks of a training step."""
    b, h, w, c = x.shape
    xn = layer_norm(x, P, name + ".norm1")
    pb, pr = (window - h % window) % window, (window - w % window) % window
    xn = F.pad(xn, (0, 0, 0, pr, 0, pb))
    hp, wp = h + pb, w + pr
    mask = None
    if shift:
        xn = torch.roll(xn, (-shift, -shift), (1, 2))
        mask = shift_mask(hp, wp, window, shift, x.device)
    y = window_attention(A, P, name + ".attn", partition(xn, window), heads, window, mask)
    y = unpartition(y, window, b, hp, wp)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    y = y[:, :h, :w]
    if keeps is not None:
        y = drop_path(y, keeps[0], rate)
    x = x + y
    hdn = dense(A, layer_norm(x, P, name + ".norm2"), P, name + ".mlp.fc1")
    hdn = dense(A, F.gelu(hdn), P, name + ".mlp.fc2")
    if keeps is not None:
        hdn = drop_path(hdn, keeps[1], rate)
    return x + hdn


def drop_path(x, keep, rate: float):
    return torch.where(keep.reshape(-1, *([1] * (x.dim() - 1))), x / (1.0 - rate), 0.0)


def patch_merge(A: Arith, P, name: str, x):
    """[B, H, W, C] -> [B, ceil(H/2), ceil(W/2), out]: 2x2 gather, LN(4C),
    reduction without bias."""
    h, w = x.shape[1:3]
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return dense(A, layer_norm(x, P, name + ".norm"), P, name + ".reduction", bias=False)


def swin(A: Arith, P, prefix: str, images, cfg: dict, keeps=None) -> list[torch.Tensor]:
    """images float [B, H, W, 3] -> the stage-2, -3, -4 outputs and the
    last merge's map, NHWC.  ``keeps[i]``: block i's drop-path masks."""
    p = prefix + ".patch_embed"
    x = A.conv2d(images.permute(0, 3, 1, 2), P[p + ".proj.weight"], P[p + ".proj.bias"],
                 stride=cfg["patch_size"]).permute(0, 2, 3, 1)
    x = layer_norm(x, P, p + ".norm")
    rates = drop_path_rates(cfg)
    outs, blk = [], 0
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            name = f"{prefix}.layers.{i}.blocks.{j}"
            shift = 0 if j % 2 == 0 else cfg["window"] // 2
            x = swin_block(A, P, name, x, cfg["num_heads"][i], cfg["window"], shift,
                           None if keeps is None else keeps[blk], rates[blk])
            blk += 1
        if i > 0:
            outs.append(x)
        x = patch_merge(A, P, f"{prefix}.layers.{i}.downsample", x)
    outs.append(x)
    return outs


def drop_path_rates(cfg: dict) -> list[float]:
    """Stochastic depth grows linearly over the blocks, 0 to the top rate."""
    n = sum(cfg["depths"])
    top = cfg.get("drop_path_rate", 0.0)
    return [top * i / (n - 1) if n > 1 else 0.0 for i in range(n)]


# ---------------------------------------------------------------- deformable decoder


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def box_mlp(A: Arith, P, name: str, x, layers: int = 3):
    for i in range(layers):
        x = dense(A, x, P, f"{name}.layers.{i}")
        if i < layers - 1:
            x = F.relu(x)
    return x


def ms_deform_attn(A: Arith, P, name: str, query, ref, src, pad_flat, shapes, det: dict):
    """Multi-scale deformable attention (Deformable DETR's PyTorch core):
    query [B, Q, C], ref [B, Q, L, 4] boxes, src [B, S, C], pad_flat [B, S]."""
    b, q, c = query.shape
    m, lv, pts = det["num_heads"], det["num_levels"], det["num_points"]
    d = c // m
    value = dense(A, src, P, name + ".value_proj").masked_fill(pad_flat[..., None], 0.0)
    off = dense(A, query, P, name + ".sampling_offsets").reshape(b, q, m, lv, pts, 2)
    w = torch.softmax(dense(A, query, P, name + ".attention_weights").reshape(b, q, m, lv * pts),
                      -1).reshape(b, q, m, lv, pts)
    loc = ref[:, :, None, :, None, :2] + off / pts * ref[:, :, None, :, None, 2:] * 0.5
    grids = 2 * loc - 1
    out = 0.0
    start = 0
    for l, (h, wd) in enumerate(shapes):
        v = value[:, start:start + h * wd].reshape(b, h, wd, m, d).permute(0, 3, 4, 1, 2)
        start += h * wd
        g = grids[:, :, :, l].permute(0, 2, 1, 3, 4).reshape(b * m, q, pts, 2)
        s = F.grid_sample(v.reshape(b * m, d, h, wd), g, mode="bilinear",
                          padding_mode="zeros", align_corners=False)   # [B*M, D, Q, P]
        wl = w[:, :, :, l].permute(0, 2, 1, 3).reshape(b * m, 1, q, pts)
        out = out + (s * wl).sum(-1)
    out = out.reshape(b, m, d, q).permute(0, 3, 1, 2).reshape(b, q, c)
    return dense(A, out, P, name + ".output_proj")


def self_attention(A: Arith, P, name: str, q, k, v, heads: int, drop=None):
    """torch MultiheadAttention's packed in-projection + out-projection;
    ``drop`` on the attention probabilities."""
    c = q.shape[-1]
    w, bias = P[name + ".in_proj_weight"], P[name + ".in_proj_bias"]
    o = attention(A, A.linear(q, w[:c], bias[:c]), A.linear(k, w[c:2 * c], bias[c:2 * c]),
                  A.linear(v, w[2 * c:], bias[2 * c:]), heads, drop=drop)
    return dense(A, o, P, name + ".out_proj")


def valid_ratio(pad: torch.Tensor) -> torch.Tensor:
    """[B, H, W] pad mask -> [B, 2] (w, h) shares of real columns and rows."""
    _, h, w = pad.shape
    return torch.stack([(~pad[:, 0, :]).sum(1).float() / w,
                        (~pad[:, :, 0]).sum(1).float() / h], -1)


def detector(A: Arith, P, prefix: str, images_u8, pad, cfg: dict, keeps=None,
             dropout=None):
    """The detector (``prefix``: its name in the state dict, "" at the top):
    -> (hs [layers+1, B, Q, C], the reference boxes of each level [layers+1,
    B, Q, 4], the four backbone maps, their pad masks).  ``dropout(x)``
    applies a training step's dropout, ``keeps[i]`` block i's drop-path."""
    drop = dropout or (lambda x: x)
    pre = prefix + "." if prefix else ""
    sw, det = cfg["swin"], cfg["detector"]
    feats = swin(A, P, pre + "backbone", normalize(images_u8, pad), sw, keeps)
    n = len(sw["depths"])
    strides = [sw["patch_size"] * 2 ** s for s in range(1, n)] + [sw["patch_size"] * 2 ** n]
    masks = [pad[:, ::s, ::s] for s in strides]
    srcs = []
    for i, f in enumerate(feats):
        name = f"{pre}input_proj.{i}"
        y = A.conv2d(f.permute(0, 3, 1, 2), P[name + ".0.weight"], P[name + ".0.bias"])
        srcs.append(group_norm(y, P, name + ".1", 32).permute(0, 2, 3, 1))
    b = images_u8.shape[0]
    shapes = [(s.shape[1], s.shape[2]) for s in srcs]
    src = torch.cat([s.reshape(b, -1, s.shape[-1]) for s in srcs], 1)
    pad_flat = torch.cat([m.reshape(b, -1) for m in masks], 1)
    vr = torch.stack([valid_ratio(m) for m in masks], 1)                # [B, L, 2]
    dm = pre + "det_module"
    c = det["d_model"]
    query = P[dm + ".query_embed.weight"]
    pos, tgt = query[:, :c][None].expand(b, -1, -1), query[:, c:][None].expand(b, -1, -1)
    ref = torch.sigmoid(dense(A, pos, P, dm + ".reference_points"))    # [B, Q, 2]
    tmp = box_mlp(A, P, dm + ".bbox_embed.0", tgt)
    ref = torch.sigmoid(torch.cat([tmp[..., :2] + inverse_sigmoid(ref), tmp[..., 2:]],
                                  -1)).detach()
    hs, refs = [tgt], [ref]
    for lid in range(det["num_layers"]):
        ln = f"{dm}.decoder_layers.{lid}"
        ref_in = ref[:, :, None] * torch.cat([vr, vr], -1)[:, None]
        q = tgt + pos
        tgt = layer_norm(tgt + drop(self_attention(A, P, ln + ".self_attn", q, q, tgt,
                                                   det["num_heads"], drop)), P, ln + ".norm2")
        ca = ms_deform_attn(A, P, ln + ".cross_attn", tgt + pos, ref_in, src, pad_flat,
                            shapes, det)
        tgt = layer_norm(tgt + drop(ca), P, ln + ".norm1")
        h = drop(F.relu(dense(A, tgt, P, ln + ".linear1")))
        tgt = layer_norm(tgt + drop(dense(A, h, P, ln + ".linear2")), P, ln + ".norm3")
        tmp = box_mlp(A, P, f"{dm}.bbox_embed.{lid + 1}", tgt)
        ref = torch.sigmoid(tmp + inverse_sigmoid(ref)).detach()
        hs.append(tgt)
        refs.append(ref)
    return torch.stack(hs), torch.stack(refs), feats, masks


# ---------------------------------------------------------------- grid network


def grid_net(A: Arith, P, prefix: str, x, mask, cfg: dict, drop=None) -> torch.Tensor:
    """x [B, S, d_in], mask bool [B, 1, 1, S] -> the last layer's output
    [B, S, d_model] (post-LN encoder layers); ``drop``: a training step's
    dropout."""
    drop = drop or identity
    out = layer_norm(drop(F.relu(dense(A, x, P, prefix + ".fc"))), P, prefix + ".layer_norm")
    for i in range(cfg["grid_layers"]):
        name = f"{prefix}.layers.{i}"
        out = mha(A, P, name + ".mhatt", out, out, out, cfg["n_heads"], mask, drop)
        out = ffn(A, P, name + ".pwff", out, drop)
    return out


def vision(A: Arith, P, images_u8, pad, cfg: dict, keeps=None, det_drop=None,
           drop=None) -> dict:
    """The captioner's visual features, as the caption generator reads them:
    ``swin_grid`` (the last merge's map, [B, S, pos_dim]), ``gri_feat`` (the
    grid network's output), ``gri_mask`` [B, 1, 1, S], ``reg_feat`` (the last
    decoder layer's queries), ``region_l1`` (the first decoder layer's).  In
    a training step ``keeps`` are the blocks' drop-path masks and
    ``det_drop`` / ``drop`` the detector's and the grid network's dropout."""
    hs, _, feats, masks = detector(A, P, "detector", images_u8, pad, cfg, keeps, det_drop)
    b = images_u8.shape[0]
    grid = feats[-1].reshape(b, -1, feats[-1].shape[-1])
    gmask = masks[-1].reshape(b, 1, 1, -1)
    return {"swin_grid": grid, "gri_mask": gmask, "reg_feat": hs[-1], "region_l1": hs[1],
            "gri_feat": grid_net(A, P, "grid_net", grid, gmask, cfg, drop)}

