"""Self-critical sequence training (SCST) with CIDEr rewards.

Parity: reference engine/caption_engine.py:388-492 (train_sc);
grit_tpu/engine/scst.py.

Per batch:
1. beam-search sample ``beam_size`` captions per image (out_size = beam size);
2. decode + PTB-tokenize on host, CIDEr-D reward per sampled caption against
   the image's reference captions (caption_engine.py:432-437);
3. baseline = per-image mean reward over the beam (:438);
4. loss = -mean_t(log p(w_t)) * (reward - baseline), averaged over B*beam (:439-441);
5. Adam step with fixed sc_lr / sc_backbone_lr (no scheduler in SC phases).

As in grit_tpu, generation and the gradient step are two separate calls with
the host's reward computation in between, and instead of differentiating
through the 20-step beam search, the update re-scores the sampled sequences
with ONE teacher-forced forward: the same log-probs the search produced
(post-EOS steps zeroed, matching ``word_logprob * seq_mask``), with a far
cheaper backward.  The reference runs beam search under live dropout and
backprops through that exact noise; re-scoring draws fresh dropout noise.
Both are unbiased REINFORCE estimators of the same objective.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from grit_tpu_torch.decoding.beam_search import beam_search
from grit_tpu_torch.engine.xe import TrainState


def make_generate_step(model, *, beam_size: int, max_len: int, bos_idx: int,
                       eos_idx: int) -> Callable:
    """SCST sampler: generate(samples, batch_size, generator=None) ->
    (sequences [B, beam, T], per-step log-probs [B, beam, T]), no gradient.

    With a ``generator`` the model runs in ``train()`` mode and draws its
    dropout masks from it (grit_tpu's ``rng``); with None it runs in
    ``eval()``."""

    @torch.no_grad()
    def generate(samples, batch_size: int, generator: Optional[torch.Generator] = None):
        if generator is None:
            model.eval()
        else:
            model.train()
            model.set_generator(generator)
        vis = model.compute_vis(samples)
        kv = model.precompute_vis_kv(vis)

        def decode_fn(token, t, vis_in, cache):
            return model.decode_step(token, t, vis_in["feat"], cache,
                                     vis_kv=vis_in["kv"], vis_fold=beam_size)

        cache = model.init_cache(batch_size * beam_size, max_len)
        res = beam_search(decode_fn, cache, {"feat": vis, "kv": kv}, batch_size, beam_size,
                          max_len, bos_idx, eos_idx, out_size=beam_size)
        return res.sequences, res.log_probs

    return generate


def sequence_log_probs(model, samples, sequences: torch.Tensor, *, bos_idx: int,
                       eos_idx: int) -> torch.Tensor:
    """Teacher-forced per-step log-probs of sampled sequences [B, beam, T],
    in the mode the model is in.

    Position t is scored given prefix [BOS, w_0..w_{t-1}]; steps after the
    first EOS contribute 0 (the reference's seq_mask zeroing,
    transformer.py:216-217)."""
    b, k, t_len = sequences.shape
    flat = sequences.reshape(b * k, t_len)
    inputs = torch.cat([torch.full((b * k, 1), bos_idx, dtype=flat.dtype, device=flat.device),
                        flat[:, :-1]], dim=1)
    vis = {name: x.repeat_interleave(k, dim=0) for name, x in model.compute_vis(samples).items()}
    # score against the processed features directly: forward(dict, seq) would
    # run the grid network again
    out = model.score_tokens(vis, inputs)                           # [B*k, T, V]
    logp = torch.gather(out, -1, flat[..., None])[..., 0]           # [B*k, T]
    # include position t iff no EOS among w_0..w_{t-1}
    seen_eos = torch.cumsum((flat == eos_idx).long(), dim=1)
    prev_eos = torch.cat([torch.zeros((b * k, 1), dtype=torch.long, device=flat.device),
                          seen_eos[:, :-1]], dim=1)
    return (logp * (prev_eos == 0).to(logp.dtype)).reshape(b, k, t_len)


def make_scst_update_step(*, bos_idx: int, eos_idx: int, model_lr: float,
                          backbone_lr: float) -> Callable:
    """-> step(state, samples, sequences [B, beam, T], rewards [B, beam],
    n_valid) -> (state, metrics): one SCST update in place, in ``train()``
    mode with the state's generator, at the fixed learning rates.

    ``n_valid`` is the true image count: a ragged batch arrives zero-padded
    to the first batch's size, and the padded rows carry reward 0 = baseline
    0, so their advantage vanishes; normalising by ``n_valid * beam`` instead
    of ``.mean()`` makes the loss and gradient exactly the true batch's.
    metrics: 0-d tensors ``loss``, ``reward``, ``reward_baseline`` (not
    synchronised)."""

    def step(state: TrainState, samples, sequences, rewards, n_valid):
        model = state.model
        model.train()
        model.set_generator(state.generator)
        state.optimizer.param_groups[0]["lr"] = model_lr
        state.optimizer.param_groups[1]["lr"] = backbone_lr
        state.optimizer.zero_grad(set_to_none=True)
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=sequences.device)
        logp = sequence_log_probs(model, samples, sequences, bos_idx=bos_idx, eos_idx=eos_idx)
        mean_logp = logp.mean(-1)        # mean over max_len incl. zeros (ref :439)
        baseline = rewards.mean(-1, keepdim=True)
        denom = float(n_valid) * rewards.shape[-1]
        loss = (-mean_logp * (rewards - baseline)).sum() / denom
        loss.backward()
        state.optimizer.step()
        return state, {"loss": loss.detach(), "reward": rewards.sum() / denom,
                       "reward_baseline": baseline.sum() * rewards.shape[-1] / denom}

    return step
