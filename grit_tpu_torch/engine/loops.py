"""Caption training loops: XE epochs, SCST epochs, the 4-phase schedule.

Parity: reference train_caption.py:95-204 (phase machine) and
engine/caption_engine.py (train_xe :312, train_sc :388, evaluate_loss :287,
log_epoch :106); grit_tpu/engine/loops.py.

Execution per step, on one device:
- XE: forward, backward and the Adam update are queued on the device's
  stream; batches stream from the host loader's threads; the loss stays on
  the device and is read back every 64 steps;
- SCST: beam-search generation -> host decode + PTB tokenize + CIDEr reward
  -> re-score/update step.  Batch i+1's generation is queued before batch i's
  rewards are computed on the host, so the two overlap.

Loader batches arrive on the host at a fixed size except for a ragged tail,
which ``ragged_padder`` pads back to the first batch's size; a data-parallel
trainer can shard what comes out of the padder.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from grit_tpu_torch.data.metrics import PTBTokenizer
from grit_tpu_torch.utils.nested import pad_leading, to_device

#: steps between reads of the on-device metrics (a read waits for the device)
DRAIN = 64


def ragged_padder(**pad_kw):
    """Tail-batch padder: remembers the FIRST batch's leading size and pads
    any smaller batch up to it (``utils.nested.pad_leading``'s conventions:
    zero image/all-valid mask; caption ints need int_fill/int_first), so every
    step of an epoch runs at one shape."""
    nominal = None

    def pad(tree, batch_size):
        nonlocal nominal
        if nominal is None:
            nominal = batch_size
        if batch_size < nominal:
            tree = pad_leading(tree, nominal, **pad_kw)
        return tree

    return pad


def log_epoch_csv(config, epoch, split, scores, train_res, which, path="result.csv"):
    """Append-only result.csv epoch table (caption_engine.py:106-131)."""
    head = ("exp, backbone, imsize, resize, raug, epoch, split, cider, B1, B4, R, M, "
            "B2, B3, t-loss, t-reward, b-reward, which, v-loss")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(head + "\n")
    backbone = "B-VG" if os.path.exists(config.model.detector.checkpoint) else "B-IM"
    t = config.dataset.transform_cfg
    text = (
        f'{config.exp.name.split("/")[-1]}, {backbone}, {t.size[0]}_{t.size[1]}, '
        f"{t.resize_name}, {t.randaug}, {epoch}, {split:<5}, "
        f'{scores["CIDEr"] * 100:3.2f}, {scores["BLEU"][0] * 100:3.2f}, '
        f'{scores["BLEU"][3] * 100:3.2f}, {scores["ROUGE"] * 100:3.2f}, '
        f'{scores["METEOR"] * 100:3.2f}, {scores["BLEU"][1] * 100:3.2f}, '
        f'{scores["BLEU"][2] * 100:3.2f}, '
        f'{train_res["loss"]:2.2f}, {train_res["reward"]:2.2f}, '
        f'{train_res["reward_baseline"]:2.2f}, {which}, {train_res["val_loss"]:1.2f}'
    )
    with open(path, "a") as f:
        f.write(text + "\n")
    print(text)


def phase_for_epoch(epoch: int, config) -> str:
    """4-phase epoch-count state machine (train_caption.py:90-103)."""
    o = config.optimizer
    fr_xe = o.freezing_xe_epochs
    fr_sc = fr_xe + o.freezing_sc_epochs
    ft_xe = fr_sc + o.finetune_xe_epochs
    ft_sc = ft_xe + o.finetune_sc_epochs
    if epoch < fr_xe:
        return "fr_xe"
    if epoch < fr_sc:
        return "fr_sc"
    if epoch < ft_xe:
        return "ft_xe"
    if epoch < ft_sc:
        return "ft_sc"
    return "done"


def total_epochs(config) -> int:
    o = config.optimizer
    return (o.freezing_xe_epochs + o.freezing_sc_epochs
            + o.finetune_xe_epochs + o.finetune_sc_epochs)


def _validation_loss(eval_loss_step, loader, device, pad_idx: int, bos_idx: int) -> float:
    running, n = 0.0, 0
    pad_val = ragged_padder(int_fill=pad_idx, int_first=bos_idx)
    for batch in loader:
        b = {"samples": batch["samples"], "captions": batch["captions"]}
        b = pad_val(b, int(b["captions"].shape[0]))
        running += float(eval_loss_step(to_device(b, device)))
        n += 1
    return running / max(n, 1)


def train_xe_epoch(xe_step, eval_loss_step, state, dataloaders, *, epoch, device, writer=None,
                   pad_idx: int = 1, bos_idx: int = 2):
    """One XE epoch + validation loss (caption_engine.py:312-385) ->
    (state, {'loss', 'reward', 'reward_baseline', 'val_loss'})."""
    state = state.epoch_tick()  # the reference's epoch-start scheduler.step()
    running = 0.0
    n = 0
    t0 = time.time()
    # metrics stay ON THE DEVICE and drain in chunks: a float() per step would
    # make the host wait for the device at every step and empty its queue
    pending_loss: list = []
    pending_lr: list = []

    def drain():
        nonlocal running, n
        if not pending_loss:
            return
        vals = torch.stack(pending_loss).cpu().numpy()
        running += float(vals.sum())
        n += len(vals)
        if writer is not None:
            for step_i, lr in pending_lr:
                writer.scalar("model_lr", float(lr), step_i)
        pending_loss.clear()
        pending_lr.clear()

    # zero-weight [BOS, pad...] rows leave the loss and the gradients unchanged
    pad_train = ragged_padder(int_fill=pad_idx, int_first=bos_idx)
    for it, batch in enumerate(dataloaders["train"]):
        batch = {"samples": batch["samples"], "captions": batch["captions"]}
        batch = pad_train(batch, int(batch["captions"].shape[0]))
        state, metrics = xe_step(state, to_device(batch, device))
        pending_loss.append(metrics["loss"])
        if writer is not None:
            pending_lr.append((epoch * len(dataloaders["train"]) + it, metrics["lr"]))
        if len(pending_loss) >= DRAIN:
            drain()
    drain()
    train_loss = running / max(n, 1)
    val_loss = _validation_loss(eval_loss_step, dataloaders["valid"], device, pad_idx, bos_idx)
    print(f"Epoch {epoch} XE: loss={train_loss:.4f} val_loss={val_loss:.4f} "
          f"({time.time() - t0:.1f}s)")
    return state, {"loss": train_loss, "reward": 0.0, "reward_baseline": 0.0,
                   "val_loss": val_loss}


def train_sc_epoch(generate_step, scst_update, eval_loss_step, state, dataloaders, cider,
                   text_field, *, beam_size, epoch, device, pad_idx: int = 1, bos_idx: int = 2):
    """One SCST epoch (caption_engine.py:388-492) with generation and reward
    overlapped -> (state, {'loss', 'reward', 'reward_baseline', 'val_loss'})."""
    running = {"loss": 0.0, "reward": 0.0, "reward_baseline": 0.0}
    n = 0
    pending = None  # (samples on the device, sequences on the device, captions)

    def reward_and_update(state, samples, sequences, captions):
        seqs = sequences.cpu().numpy()  # [Bpad, beam, T]; waits for the generation
        b_pad, k, t_len = seqs.shape
        b = len(captions)  # true count; rows past it are ragged-batch padding
        caps_gen = text_field.decode(seqs[:b].reshape(-1, t_len))
        caps_gt = list(itertools.chain(*([c] * k for c in captions)))
        gen_tok = PTBTokenizer.tokenize(caps_gen)
        gt_tok = PTBTokenizer.tokenize(caps_gt)
        reward = cider.compute_score(gt_tok, gen_tok)[1].astype(np.float32).reshape(b, k)
        reward = np.concatenate([reward, np.zeros((b_pad - b, k), np.float32)], axis=0)
        return scst_update(state, samples, sequences, reward, float(b))

    def account(metrics):
        nonlocal n
        for key in running:
            running[key] += float(metrics[key])
        n += 1

    # a ragged tail generates at the first batch's size; reward_and_update
    # scores only the true ``len(captions)`` rows and the SCST update is
    # exactly invariant to padded rows
    pad_gen = ragged_padder()
    for batch in dataloaders["train_dict"]:
        samples = pad_gen(batch["samples"], len(batch["image_id"]))
        samples = to_device(samples, device)
        bs = int(next(iter(samples.values())).shape[0] if isinstance(samples, dict)
                 else samples.images.shape[0])
        sequences, _ = generate_step(samples, bs, state.generator)
        # overlap: while the device generates this batch, score the previous
        if pending is not None:
            state, metrics = reward_and_update(state, *pending)
            account(metrics)
        pending = (samples, sequences, batch["captions"])

    if pending is not None:
        state, metrics = reward_and_update(state, *pending)
        account(metrics)

    res = {k: v / max(n, 1) for k, v in running.items()}
    res["val_loss"] = _validation_loss(eval_loss_step, dataloaders["valid"], device, pad_idx,
                                       bos_idx)
    print(f"Epoch {epoch} SCST: loss={res['loss']:.4f} reward={res['reward']:.3f} "
          f"baseline={res['reward_baseline']:.3f} val_loss={res['val_loss']:.4f}")
    return state, res
