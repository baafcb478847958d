"""Karpathy-split beam-search evaluation CLI (reference eval_caption.py:19-60;
grit_tpu's root eval_caption.py, whose overrides it takes).

  python -m grit_tpu_torch.eval_caption exp.checkpoint=path [overrides...]

``exp.checkpoint`` is a checkpoint directory of the port's trainer
(``outputs/<name>/checkpoints/<role>``, see ``engine/checkpoint.py``) or a
reference ``.pth``.  The model computes in ``model.compute_dtype`` (fp32 by
default, as the JAX CLI).  ``exp.device`` (or ``--device``) defaults to
``cuda``, and the CLI raises without a card; ``exp.device=cpu`` runs on the
CPU.  The helpers here are shared by the other evaluation CLIs and the
feature-extraction tools.
"""

from __future__ import annotations

import sys

import torch


def caption_config(argv):
    """The caption config with dotted overrides applied, ``--device X`` read
    as ``exp.device=X``; ``exp.device`` defaults to ``cuda``."""
    from grit_tpu_torch.config import default_caption_config

    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        argv[i:i + 2] = [f"exp.device={argv[i + 1]}"]
    config = default_caption_config()
    config.exp.device = "cuda"
    return config.apply_overrides(argv)


def config_device(config, who: str) -> torch.device:
    """``config.exp.device``; raises for ``cuda`` without a card."""
    device = torch.device(config.exp.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available "
                           "(pass exp.device=cpu or --device cpu to run on the CPU)")
    return device


def compute_dtype(config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config.model.compute_dtype]


def load_any_checkpoint(path: str, model) -> None:
    """Load a reference ``.pth`` or a checkpoint directory of the port's
    trainer into ``model`` in place, strict=False style (the reference's
    train_caption.py:39): parameters the checkpoint lacks keep their initial
    values, and the counts are printed."""
    from grit_tpu_torch.convert import load_reference_checkpoint
    from grit_tpu_torch.engine import checkpoint as ckpt

    if path.endswith(".pth"):
        miss, unexp = ckpt.load_params_flexible(model, load_reference_checkpoint(path))
        print(f"load: missing={miss}, unexpected={unexp}")
        return
    miss, unexp = ckpt.load_params_flexible(model, ckpt.restore_checkpoint_path(path)["state_dict"])
    if miss or unexp:
        print(f"load: missing={miss}, unexpected={unexp}")


def load_captioner(config, device, dtype: torch.dtype, checkpoint: str):
    """The captioner in ``eval()``, computing in ``dtype``, with
    ``checkpoint``'s weights over seed-0 random ones."""
    from grit_tpu_torch.models.captioner import build_captioner

    model = build_captioner(config, device=device, dtype=dtype, seed=0)
    load_any_checkpoint(checkpoint, model)
    return model


def main(argv=None):
    from grit_tpu_torch.data.coco import build_coco_dataloaders
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.engine.evaluator import evaluate_metrics, make_caption_generator

    config = caption_config(sys.argv[1:] if argv is None else argv)
    device = config_device(config, "eval_caption")
    model = load_captioner(config, device, compute_dtype(config), config.exp.checkpoint)
    text_field = TextField(vocab_path=config.dataset.vocab_path)
    dataloaders, _ = build_coco_dataloaders(config, mode="finetune")
    m = config.model
    generate = make_caption_generator(model, beam_size=m.beam_size, max_len=m.beam_len,
                                      bos_idx=m.bos_idx, eos_idx=m.eos_idx)
    for split in ("valid_dict", "test_dict"):
        scores, _, avg_time = evaluate_metrics(generate, dataloaders[split], text_field,
                                               device=device, split=split.replace("_dict", ""))
        print(f"{split}: {scores}  ({avg_time:.4f}s/batch)")


if __name__ == "__main__":
    main()
