"""Operations and bytes of GRIT's Swin backbone, from the configuration's
widths and the image bucket: the yardstick of ``mfu`` and of the GEMM
roofline.  Counts are multiply-adds times two.

The backbone's products, as the model defines them (each a GEMM of M rows,
N outputs and K inputs):

- per block, qkv (N = 3C, K = C) and the output projection (N = K = C) over
  the map padded to whole windows (the model pads after LN1 and attends over
  the padded windows); fc1 (N = 4C, K = C) and fc2 (N = C, K = 4C) over the
  map's real tokens;
- per stage, the patch merge's reduction (N = 2C, or ``pos_dim`` at the last
  stage; K = 4C) over the merged map.

Attention itself (QK^T and PV over each window of N = window^2 tokens) is
counted for ``mfu`` and is not a GEMM launch.  The patch embedding is a 4x4
convolution.  Images smaller than the bucket are computed at the bucket's
size, as the model runs them.
"""

from __future__ import annotations


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def stage_maps(sw: dict, hw: tuple[int, int]) -> list[tuple[int, int]]:
    """The map (H, W) each stage's blocks run on."""
    h, w = hw[0] // sw["patch_size"], hw[1] // sw["patch_size"]
    out = []
    for _ in sw["depths"]:
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return out


def gemms(sw: dict, batch: int, hw: tuple[int, int], train: bool = False) -> list[dict]:
    """Every GEMM launch of one forward of the backbone, in order:
    ``{"m", "n", "k", "bias", "resid"}`` (``resid``: the epilogue reads a
    residual of M x N).  In evaluation every product of a block runs over
    the map padded to whole windows, the projection and fc2 adding the
    residual.  ``train``: attention's products run over the padded map, the
    projection without a residual, the MLP over the real tokens, fc2 adding
    the residual only in a block without drop-path (the branch is returned
    where drop-path may drop it)."""
    out = []
    win = sw["window"]
    n_blocks = sum(sw["depths"])
    top = sw.get("drop_path_rate", 0.0)
    blk = 0
    for i, ((h, w), depth) in enumerate(zip(stage_maps(sw, hw), sw["depths"])):
        c = sw["embed_dim"] * 2 ** i
        hp, wp = ceil_to(h, win), ceil_to(w, win)
        pad_rows = batch * hp * wp
        real = batch * h * w
        mlp_rows = real if train else pad_rows
        for _ in range(depth):
            rate = top * blk / (n_blocks - 1) if n_blocks > 1 else 0.0
            blk += 1
            out.append({"m": pad_rows, "n": 3 * c, "k": c, "bias": True, "resid": False})
            out.append({"m": pad_rows, "n": c, "k": c, "bias": True, "resid": not train})
            out.append({"m": mlp_rows, "n": 4 * c, "k": c, "bias": True, "resid": False})
            out.append({"m": mlp_rows, "n": c, "k": 4 * c, "bias": True,
                        "resid": not train or rate == 0.0})
        n_out = sw["pos_dim"] if i == len(sw["depths"]) - 1 else 2 * c
        out.append({"m": batch * -(-h // 2) * -(-w // 2), "n": n_out, "k": 4 * c,
                    "bias": False, "resid": False})
    return out


def gemm_least_s(g: dict, bytes_per: int, peak_flops: float, peak_bw: float) -> float:
    """The least time of one GEMM launch: the larger of its operations over
    the peak and its bytes (each input read once, each output written once)
    over the bandwidth."""
    m, n, k = g["m"], g["n"], g["k"]
    flops = 2.0 * m * n * k
    elems = m * k + n * k + m * n + (n if g["bias"] else 0) + (m * n if g["resid"] else 0)
    return max(flops / peak_flops, elems * bytes_per / peak_bw)


def model_flops(sw: dict, batch: int, hw: tuple[int, int]) -> float:
    """One forward of the backbone as the model defines it: the patch
    embedding, every block (padded windows for attention, real tokens for
    the MLP) and every merge."""
    h0, w0 = hw[0] // sw["patch_size"], hw[1] // sw["patch_size"]
    total = 2.0 * batch * h0 * w0 * sw["embed_dim"] * 3 * sw["patch_size"] ** 2
    win = sw["window"]
    n_tok = win * win
    for i, ((h, w), depth) in enumerate(zip(stage_maps(sw, hw), sw["depths"])):
        c = sw["embed_dim"] * 2 ** i
        pad = batch * ceil_to(h, win) * ceil_to(w, win)
        real = batch * h * w
        per_block = (2.0 * pad * c * 4 * c          # qkv and the projection
                     + 2.0 * 2 * pad * n_tok * c     # QK^T and PV
                     + 2.0 * real * c * 8 * c)       # fc1 and fc2
        total += depth * per_block
        n_out = sw["pos_dim"] if i == len(sw["depths"]) - 1 else 2 * c
        total += 2.0 * batch * -(-h // 2) * -(-w // 2) * 4 * c * n_out
    return total
