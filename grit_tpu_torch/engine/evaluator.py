"""Caption evaluation: beam search on the device, decode and metrics on the
host.

Parity: reference engine/caption_engine.py:144-230 (evaluate_metrics) and
:233-284 (inference_coco_test); grit_tpu/engine/evaluator.py.

The per-batch wall-clock, from a batch's dispatch to its tokens on the host,
is recorded and printed like the reference's throughput metric of record
(caption_engine.py:181-192).
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Callable

import torch

from grit_tpu_torch.data.metrics import PTBTokenizer, compute_scores
from grit_tpu_torch.decoding.beam_search import beam_search
from grit_tpu_torch.parallel.distributed import allgather_pyobj, rank, world_size
from grit_tpu_torch.utils.nested import pad_leading, to_device


def make_caption_generator(model, *, beam_size: int, max_len: int, bos_idx: int,
                           eos_idx: int) -> Callable:
    """-> generate(samples: ImageBatch on the model's device, batch_size)
    returning the top beam's tokens [B, max_len].  The model runs in the mode
    it is in: put a training model in ``eval()`` first."""

    @torch.inference_mode()
    def generate(samples, batch_size: int) -> torch.Tensor:
        vis = model.compute_vis(samples)
        # the step-invariant visual K/V are projected once per batch
        kv = model.precompute_vis_kv(vis)

        def decode_fn(token, t, vis_in, cache):
            # vis stays per image: the cross attentions fold the beams into
            # the query rows instead of tiling the K/V
            return model.decode_step(token, t, vis_in["feat"], cache,
                                     vis_kv=vis_in["kv"], vis_fold=beam_size)

        cache = model.init_cache(batch_size * beam_size, max_len)
        res = beam_search(decode_fn, cache, {"feat": vis, "kv": kv}, batch_size, beam_size,
                          max_len, bos_idx, eos_idx, out_size=1)
        return res.sequences[:, 0]

    return generate


def evaluate_metrics(generate_fn: Callable, dataloader, text_field, *, device, epoch: int = 0,
                     split: str = "test", verbose: bool = True):
    """-> (scores dict or None, results list, avg seconds/batch).

    ``dataloader`` yields dict-mode batches on the host (``samples``,
    ``image_id`` and, for scoring, ``captions``: the references of each
    image); ``generate_fn`` is ``make_caption_generator``'s."""
    gen, gts = {}, {}
    results = []
    times = []

    def consume(it, batch, out_dev, t_dispatch):
        out = out_dev.cpu().numpy()   # waits for the batch's beam search
        times.append(time.time() - t_dispatch)
        out = out[: len(batch["image_id"])]  # drop pad rows of a ragged tail
        caps_gen = text_field.decode(out, join_words=False)
        for i, gen_i in enumerate(caps_gen):
            # collapse repeated words (caption_engine.py:196)
            gen_str = " ".join(k for k, _ in itertools.groupby(gen_i))
            key = f"{it}_{i}"
            gen[key] = [gen_str]
            if "captions" in batch:
                gts[key] = batch["captions"][i]
            results.append({"image_id": batch["image_id"][i], "caption": gen_str})
        if verbose and it % 100 == 0:
            print(f"Number of iterations: {it + 1}, batch_size={len(batch['image_id'])}, "
                  f"Total time per 1 batch: {sum(times) / len(times):0.5f}s")

    # pipeline: batch i+1's launches are queued before batch i's tokens are
    # read back, so the host's decode and bookkeeping overlap the device
    pending = None
    nominal_bs = None
    for it, batch in enumerate(iter(dataloader)):
        bs = len(batch["image_id"])
        samples = batch["samples"]
        if nominal_bs is None:
            nominal_bs = bs
        if bs < nominal_bs:
            # the ragged FINAL batch runs at the first batch's size (one shape
            # for the whole evaluation); consume() cuts the outputs back
            samples = pad_leading(samples, nominal_bs)
        t_dispatch = time.time()
        out_dev = generate_fn(to_device(samples, device), max(bs, nominal_bs))
        if pending is not None:
            consume(*pending)
        pending = (it, batch, out_dev, t_dispatch)
    if pending is not None:
        consume(*pending)

    avg_time = sum(times) / max(len(times), 1)
    if verbose:
        print(f"Epoch: {epoch} iters: {len(times)}\nTotal time per 1 batch: {avg_time:0.5f}s")
    scores = None
    if gts:
        gts_tok = PTBTokenizer.tokenize(gts)
        gen_tok = PTBTokenizer.tokenize(gen)
        scores, _ = compute_scores(gts_tok, gen_tok)
        if verbose:
            print(f"Epoch {epoch}: {split} scores: {scores}")
    return scores, results, avg_time


def evaluate_splits(generate_fn: Callable, loaders: dict, text_field, *, device,
                    epoch: int = 0) -> dict:
    """Scores of each split of ``loaders`` (``{split: loader}``) -> ``{split:
    scores}`` on every rank.  With two or more ranks the evaluation is
    rank-specialised (reference train_caption.py:149-179; grit_tpu's
    train_caption.py:255-276): split i runs whole on rank i % world (valid on
    rank 0, test on rank 1), on the rank's local model, and the scores are
    all-gathered, so that every rank takes the same best-checkpoint decision.
    One rank runs every split."""
    mine = {}
    for i, (split, loader) in enumerate(loaders.items()):
        if i % world_size() == rank():
            mine[split], _, _ = evaluate_metrics(generate_fn, loader, text_field, device=device,
                                                 epoch=epoch, split=split)
    merged = {}
    for scores in allgather_pyobj(mine):
        merged.update(scores)
    return {split: merged[split] for split in loaders}


def caption_batches(generate_fn, batches, text_field, *, device) -> list[dict]:
    """Caption every ``(ImageBatch, image ids)`` of ``batches`` (the online
    and nocaps CLIs' loop; grit_tpu's eval_caption_online.py:55-68): the top
    beam's tokens decoded to words, ``[{"image_id", "caption"}, ...]``."""
    results = []
    for images, ids in batches:
        out = generate_fn(images.to(device), len(ids)).cpu().numpy()
        results += [{"image_id": i, "caption": c}
                    for i, c in zip(ids, text_field.decode(out))]
    return results


def inference_coco_test(generate_fn, dataloader, text_field, *, device, split: str = "test"):
    """Leaderboard json generation (caption_engine.py:233-284)."""
    _, results, _ = evaluate_metrics(generate_fn, dataloader, text_field, device=device,
                                     split=split)
    with open(f"result_{split}.json", "w") as f:
        json.dump(results, f)
    return results
