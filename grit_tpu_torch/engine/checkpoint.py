"""``torch.save`` checkpointing for caption training and detector pre-training.

The JAX package writes Orbax trees (grit_tpu/engine/checkpoint.py); the port
goes back to the reference's ``torch.save`` dict checkpoints
(engine/caption_engine.py:83-103) with:

- the same logical content: parameters, optimizer state, scheduler tick
  counter, epoch, best CIDErs, the state of the dropout generator, and a
  config snapshot;
- the same file roles: ``last``, ``best_valid``, ``best_test``, per-phase and
  per-epoch checkpoints (train_caption.py:181-202), and the detector
  trainer's ``detector_last`` and ``detector_epoch_N``
  (detection/hooks.py::CheckpointHook), each a directory
  ``<workdir>/checkpoints/<name>/`` holding ``state.pth`` and ``config.yaml``.

The model's part (``state_dict``) carries the reference's torch parameter
names, so ``convert.state_dict_to_params`` takes it to the JAX package and
``convert.params_to_state_dict`` back.  ``strict=False`` loads report missing
and unexpected key counts like the reference (train_caption.py:39,132).

Data parallel: rank 0 writes and every rank then meets at a barrier, so a
checkpoint is whole before any rank reads it; the parameters saved are the
wrapped module's (no ``module.`` prefix), so a data-parallel checkpoint loads
into one process, and every rank restores the same file.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from grit_tpu_torch.parallel.distributed import (allgather_pyobj, barrier, is_main_process,
                                                 rank, world_size)
from grit_tpu_torch.parallel.mesh import unwrap

STATE_FILE = "state.pth"


def _ckpt_dir(workdir: str, name: str) -> str:
    return os.path.join(os.path.abspath(workdir), "checkpoints", name)


def save_checkpoint(workdir: str, name: str, *, state: Any, epoch: int,
                    best_ciders: tuple[float, float] = (0.0, 0.0), scores: Any = None,
                    config: Any = None) -> None:
    """Save a named checkpoint (e.g. 'last', 'best_valid', 'ft_xe', 'epoch_17')
    of an ``engine.xe.TrainState``: rank 0 writes, every rank waits for it.
    Under data parallel the dropout generators' states of all ranks are
    saved too (``generator_states``): each rank draws its own masks."""
    gen = state.generator
    gens = allgather_pyobj(None if gen is None else gen.get_state())
    if is_main_process():
        path = _ckpt_dir(workdir, name)
        os.makedirs(path, exist_ok=True)
        payload = {
            "state_dict": unwrap(state.model).state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "global_steps": int(state.global_steps),
            "epoch": int(epoch),
            "best_ciders": [float(c) for c in best_ciders],
            "generator_state": gens[0],
        }
        if len(gens) > 1:
            payload["generator_states"] = gens
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if config is not None:
            config.to_yaml(os.path.join(path, "config.yaml"))
    barrier("checkpoint_saved")


def restore_checkpoint_path(path: str) -> dict:
    """Restore a checkpoint from a direct directory path (a previously saved
    ``.../checkpoints/<name>``); returns the payload dict, on the CPU."""
    file = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"Checkpoint at {path} not found.")
    return torch.load(file, map_location="cpu", weights_only=True)


def restore_checkpoint(workdir: str, name: str) -> dict:
    """Restore a named checkpoint; returns the payload dict."""
    return restore_checkpoint_path(_ckpt_dir(workdir, name))


def load_train_state(state: Any, payload: dict, *, params_only: bool = False) -> Any:
    """Load a payload into an ``engine.xe.TrainState`` in place: parameters,
    and unless ``params_only`` (the SC warm-start from ``best_valid``) also the
    optimizer state, the scheduler tick and the dropout generator's state."""
    unwrap(state.model).load_state_dict(payload["state_dict"], strict=True)
    if not params_only:
        state.optimizer.load_state_dict(payload["optimizer"])
        state.global_steps = int(payload["global_steps"])
        gens = payload.get("generator_states") or [payload.get("generator_state")]
        gen = gens[rank()] if len(gens) == world_size() else gens[0]
        if state.generator is not None and gen is not None:
            state.generator.set_state(gen)
    return state


@torch.no_grad()
def load_params_flexible(module: torch.nn.Module, loaded: dict,
                         prefix: Optional[str] = None) -> tuple[int, int]:
    """strict=False-style merge into ``module`` in place: copy the entries of
    ``loaded`` (a state_dict; with ``prefix``, only its keys under that prefix,
    stripped) whose name and shape match, and count the rest.  Returns
    (n_missing, n_unexpected), mirroring the reference's load report
    (train_caption.py:39)."""
    if prefix:
        loaded = {k[len(prefix):]: v for k, v in loaded.items() if k.startswith(prefix)}
    own = module.state_dict()
    missing = 0
    for name, t in own.items():
        src = loaded.get(name)
        if src is None or tuple(src.shape) != tuple(t.shape):
            missing += 1
        else:
            t.copy_(torch.as_tensor(src).to(t.dtype))
    return missing, len([k for k in loaded if k not in own])
