"""Multi-rank dry run: one XE step and one beam search over n ranks against
one process (grit_tpu's ``__graft_entry__.py::dryrun_multichip``), in its
layouts: ``dp{n}`` and, when n >= 4 and even, ``dp{n/2}tp2`` (the tensor axis
of ``parallel.mesh``: the FFNs, the Swin MLPs and, at this vocab of 128, the
vocab head split over two ranks).

  python -m grit_tpu_torch.dryrun 2 cpu       # two gloo ranks on the CPU
  python -m grit_tpu_torch.dryrun 4 cpu       # dp4, then dp2tp2, on 4 gloo ranks
  python -m grit_tpu_torch.dryrun 2 cuda      # NCCL across two cards, or gloo
                                              # on one card if only one is there

A captioner of tiny widths (Swin head dim 32, MSDA head width 32, as the
kernels take them on the card), fp32, dropouts off (each rank draws its own
masks), random weights from seed 0.  A global batch of ``2 * n`` rows goes
through n ranks in their shares (``parallel.mesh.shard_batch``) and through
one process in the same row groups, one after the other
(``one_process_xe_step``): one forward of all the rows would round
differently on the card, where cuBLAS and cuDNN pick their kernels by the
batch, and a ReLU gate or a bilinear floor could then flip.  Held: the XE
loss (relative 1e-6), every parameter after the step (1e-3 of the learning
rate, beyond the f32 rounding of the parameter, where the gradient is above
1e-6; within 2 learning rates elsewhere, where Adam's first step is the sign
of rounding noise; under tp the whole parameters gathered from the shards),
the ranks' replicated parameters equal bit for bit and each shard equal
across its data peers, and the beam-search captions of the initial weights
token for token.  A batch is dealt over the data axis only: a tensor group's
ranks see the same rows, and each layout's one-process run takes its data
axis's row groups.  All layouts of a call share one start of the ranks.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

LOSS_RTOL = 1e-6
UPDATE_TOL = 1e-3   # of the learning rate
SCHED = dict(num_epochs=10, num_its_per_epoch=100, init_lr=1e-4, min_lr=1e-4,
             warmup_init_lr=1e-5)
BACKBONE_LR = 1e-5
BEAM, BEAM_LEN, BOS, EOS, PAD, VOCAB = 3, 10, 2, 3, 1, 128


def tiny_captioner(device, seed: int = 0):
    """The captioner's modules at tiny widths, in train() with f32 weights."""
    from grit_tpu_torch.models.cap_generator import CaptionGenerator
    from grit_tpu_torch.models.captioner import GRITCaptioner, init_weights
    from grit_tpu_torch.models.det_module import DetectionModule
    from grit_tpu_torch.models.detector import Detector
    from grit_tpu_torch.models.grid_net import GridFeatureNetwork
    from grit_tpu_torch.models.swin import SwinTransformer

    d = 128
    with torch.device(device):
        model = GRITCaptioner(
            Detector(SwinTransformer(embed_dim=32, depths=(1, 1), num_heads=(1, 2), window=4,
                                     pos_dim=64, drop_path_rate=0.0),
                     DetectionModule(d_model=d, n_heads=4, num_layers=2, dim_feedforward=256,
                                     num_levels=2, num_points=2, num_classes=16,
                                     num_queries=10, dropout=0.0),
                     hidden_dim=d),
            GridFeatureNetwork(2, d_in=64, d_model=d, n_heads=4, d_ff=256, dropout=0.0),
            CaptionGenerator(VOCAB, 16, 2, PAD, d_model=d, n_heads=4, d_ff=256, dropout=0.0))
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.train()


def global_batch(n: int) -> dict:
    """``2 * n`` rows from seed 0: float images in [0, 1) without padding, and
    captions [BOS, 6 words, EOS]."""
    from grit_tpu_torch.utils.nested import ImageBatch

    rows = 2 * n
    rng = np.random.RandomState(0)
    images = ImageBatch(torch.from_numpy(rng.rand(rows, 64, 64, 3).astype(np.float32)),
                        torch.zeros((rows, 64, 64), dtype=torch.bool))
    seq = np.concatenate([np.full((rows, 1), BOS), rng.randint(4, VOCAB, (rows, 6)),
                          np.full((rows, 1), EOS)], 1)
    return {"samples": images, "captions": torch.from_numpy(seq)}


def one_process_xe_step(state, parts: list, *, pad_idx: int, sched_cfg: dict) -> float:
    """One process's XE step (``engine.xe.make_xe_train_step``'s update) over
    a global batch given as the ranks' row groups: each group's forward and
    backward at a rank's shapes, the gradients accumulated, each normalised
    by the whole batch's token count, then one update -> the loss.  The model
    should train what the ranks train (``parallel.mesh.exclude_untrained``):
    a parameter that stops requiring a gradient can change which kernels
    the forward runs, and so its rounding."""
    from grit_tpu_torch.engine.optim import cosine_lr_schedule
    from grit_tpu_torch.engine.xe import nll_sum

    model, opt = state.model, state.optimizer
    model.train()
    model.set_generator(state.generator)
    opt.param_groups[0]["lr"] = cosine_lr_schedule(state.global_steps, **sched_cfg)
    opt.zero_grad(set_to_none=True)
    tokens = sum((p["captions"][:, 1:] != pad_idx).sum() for p in parts).float()
    loss = 0.0
    for p in parts:
        share = nll_sum(model(p["samples"], p["captions"]), p["captions"], pad_idx)[0] / tokens
        share.backward()
        loss += float(share.detach())
    opt.step()
    state.global_steps += 1
    return loss


def layouts(n: int) -> list[tuple[str, int, int]]:
    """(name, data axis, tensor axis) of each layout the dry run holds on n
    ranks, as ``__graft_entry__.py``'s."""
    out = [(f"dp{n}", n, 1)]
    if n >= 4 and n % 2 == 0:
        out.append((f"dp{n // 2}tp2", n // 2, 2))
    return out


def run_case(n: int, device, dp: int | None = None, tp: int = 1, groups=None) -> dict:
    """The beam-search captions of the initial weights and one XE step, on
    this rank's share of the global batch (its data rank's rows; ``groups``:
    this rank's (data group, tensor group), ``parallel.mesh.make_groups(dp,
    tp)``), or in one process over the ``dp`` shares in turn -> {"loss",
    "sequences", "params" (whole), "own" (this rank's, slices included),
    "split", "grads" (one process), "lr", "dp_rank", "tp_rank"} on the host."""
    from grit_tpu_torch.engine.optim import build_optimizer, cosine_lr_schedule
    from grit_tpu_torch.engine.scst import make_generate_step
    from grit_tpu_torch.engine.xe import TrainState, make_xe_train_step, xe_probe
    from grit_tpu_torch.parallel.distributed import rank, world_size
    from grit_tpu_torch.parallel.mesh import (exclude_untrained, gather_tp_state, global_sum,
                                              shard_batch, shard_model, split_params,
                                              tie_replicated_grads, tp_plan,
                                              wrap_data_parallel)
    from grit_tpu_torch.utils.nested import to_device

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dp = n if dp is None else dp
    dp_group, tp_group = groups or (None, None)
    model = tiny_captioner(device)
    plan = tp_plan(model, tp)
    if plan:
        shard_model(model, plan, tp_group)
    mine = range(dp) if world_size() == 1 else [rank() // tp]
    parts = [to_device(shard_batch(global_batch(n), r, dp, int_fill=PAD, int_first=BOS), device)
             for r in mine]
    generate = make_generate_step(model, beam_size=BEAM, max_len=BEAM_LEN, bos_idx=BOS,
                                  eos_idx=EOS)
    sequences = [generate(p["samples"], int(p["captions"].shape[0]), None)[0].cpu().numpy()
                 for p in parts]

    optimizer = build_optimizer(model, model_lr=SCHED["init_lr"], backbone_lr=BACKBONE_LR)
    tie_replicated_grads(optimizer, model, tp_group)
    trained = [p for g in optimizer.param_groups for p in g["params"]]
    probe = xe_probe(parts[:1], pad_idx=PAD)
    state = TrainState(model, optimizer, global_steps=1,
                       generator=torch.Generator(device=device).manual_seed(0))
    if world_size() == 1:
        exclude_untrained(model, trained=trained, probe=probe)
        loss = one_process_xe_step(state, parts, pad_idx=PAD, sched_cfg=SCHED)
    else:
        state.model = wrap_data_parallel(model, device, trained=trained, probe=probe,
                                         group=dp_group)
        state, metrics = make_xe_train_step(pad_idx=PAD, sched_cfg=SCHED)(state, parts[0])
        loss = float(global_sum(metrics["loss"]))
    own = {k: p.detach().cpu() for k, p in model.named_parameters()}
    whole = gather_tp_state(model) if plan else own
    return {"loss": loss, "lr": cosine_lr_schedule(1, **SCHED), "sequences": sequences,
            "params": {k: whole[k].detach().cpu() for k in own}, "own": own,
            "split": sorted(split_params(model)), "dp_rank": mine[0], "tp_rank": rank() % tp,
            "grads": {k: None if p.grad is None else p.grad.cpu()
                      for k, p in model.named_parameters()} if world_size() == 1 else None}


def run_layouts(n: int, device, layout_list: list) -> list[dict]:
    """In a rank: ``run_case`` in each layout, its groups made here."""
    from grit_tpu_torch.parallel.mesh import make_groups

    return [run_case(n, device, dp, tp, make_groups(dp, tp)) for _, dp, tp in layout_list]


def update_error(params: dict, ref: dict, grads: dict, lr: float) -> tuple[float, str]:
    """The worst parameter difference in learning rates, beyond one f32
    rounding of the parameter (two updates that agree within UPDATE_TOL lr
    may still round to neighbouring floats), where it counts against
    UPDATE_TOL: (max over leaves where |g_ref| > 1e-6, the leaf); elsewhere
    the difference must stay within 2 lr (checked here)."""
    worst, where = 0.0, ""
    for name, p in params.items():
        err = ((p - ref[name]).abs() - torch.finfo(torch.float32).eps * ref[name].abs()).clamp(min=0)
        g = grads.get(name)
        big = torch.zeros_like(err, dtype=torch.bool) if g is None else g.abs() > 1e-6
        if bool((err[~big] > 2 * lr).any()):
            raise AssertionError(f"{name}: a parameter with a noise-level gradient moved "
                                 f"{float(err[~big].max()):.3e} from one process's")
        if bool(big.any()) and float(err[big].max()) / lr > worst:
            worst, where = float(err[big].max()) / lr, name
    return worst, where


def check_layout(name: str, outs: list[dict], ref: dict) -> dict:
    """Hold one layout's ranks (``run_case``'s outputs in rank order) against
    its one-process run; raises on a mismatch -> the numbers compared."""
    if not np.isfinite(ref["loss"]):
        raise AssertionError(f"{name}: non-finite one-process loss {ref['loss']}")
    losses = [o["loss"] for o in outs]
    if any(abs(loss - ref["loss"]) > LOSS_RTOL * abs(ref["loss"]) for loss in losses):
        raise AssertionError(f"{name}: XE loss {losses} != one process's {ref['loss']}")
    sequences = np.concatenate(ref["sequences"])
    by_dp: dict = {}
    for o in outs:
        first = by_dp.setdefault(o["dp_rank"], o["sequences"][0])
        if not np.array_equal(first, o["sequences"][0]):
            raise AssertionError(f"{name}: a tensor group's ranks chose different beams")
    if not np.array_equal(np.concatenate([by_dp[r] for r in sorted(by_dp)]), sequences):
        raise AssertionError(f"{name}: beam-search captions differ from one process's")
    split = set(outs[0]["split"])
    for o in outs:
        for pname, p in o["own"].items():
            peers = [q for q in outs if pname not in split or q["tp_rank"] == o["tp_rank"]]
            if any(not torch.equal(p, q["own"][pname]) for q in peers):
                raise AssertionError(f"{name}: {pname} differs between ranks that hold the "
                                     "same values")
    worst, where = update_error(outs[0]["params"], ref["params"], ref["grads"], ref["lr"])
    if worst > UPDATE_TOL:
        raise AssertionError(f"{name}: {where} updated {worst:.3e} learning rates from one "
                             "process's")
    print(f"dryrun[{name}] OK: loss {losses[0]:.7f} (one process {ref['loss']:.7f}), update "
          f"within {worst:.2e} lr, captions equal over {sequences.shape}, "
          f"{len(split)} parameters split", flush=True)
    return {"loss": losses[0], "ref_loss": ref["loss"], "update_err_lr": worst,
            "captions": list(sequences.shape), "split": sorted(split)}


def dryrun_multichip(n: int, device: str = "cpu", backend: str | None = None,
                     deadline: float = 600.0) -> dict:
    """n ranks against one process in each of ``layouts(n)`` (see the module's
    docstring) -> the first layout's numbers, with every layout's under
    "layouts"; raises on a mismatch.  On the card: NCCL, rank r on card r,
    when n cards are there; else, as asked by ``backend`` or when fewer cards
    than n are there, gloo with every rank on card 0 (NCCL refuses a card
    twice)."""
    from grit_tpu_torch.parallel.distributed import run_ranks

    local_ranks = None
    if device == "cuda":
        from grit_tpu_torch.ops import _cuda

        _cuda.library()     # built here once, before the ranks start
        if backend is None:
            backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
        if backend == "gloo" or torch.cuda.device_count() < n:
            local_ranks = [0] * n
    todo = layouts(n)
    print(f"dryrun_multichip({n}, {device}): {', '.join(x[0] for x in todo)}; backend "
          f"{backend or 'gloo'}" + (", every rank on card 0" if local_ranks else ""), flush=True)
    refs = [run_case(n, device, dp, tp) for _, dp, tp in todo]
    outs = run_ranks("grit_tpu_torch.dryrun:run_layouts", n, args=(n, device, todo),
                     device=device, backend=backend, local_ranks=local_ranks, deadline=deadline)
    checked = {name: check_layout(name, [o[i] for o in outs], refs[i])
               for i, (name, _, _) in enumerate(todo)}
    out = {**checked[todo[0][0]], "layouts": checked}
    print(f"dryrun_multichip({n}, {device}) OK: {', '.join(checked)}", flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cpu")
