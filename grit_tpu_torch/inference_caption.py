"""Single-image caption inference CLI (reference inference_caption.py:32-69).

  python -m grit_tpu_torch.inference_caption --image x.jpg --checkpoint ckpt.pth \
      [--beam 5] [--device cuda] [--vocab vocab.json] [model.key=value ...]

Loads a reference ``.pth`` with ``load_state_dict(strict=True)`` and runs the
port in bf16 on a GPU (fp32 with ``--device cpu``); config overrides use
grit_tpu_torch.config's dotted syntax.  Without ``--checkpoint`` the weights
are the random ones of seed 0.  With ``model.cap_generator.decoder_name=
mla_moe`` (the language-model decoder, ``models/lm_captioner.py``) the
caption is printed as token ids of the language model's vocabulary: no
tokenizer of it is in the repository.
"""

from __future__ import annotations

import argparse

import torch


def caption_image(image_path, checkpoint=None, config=None, beam_size=None, device="cuda"):
    from PIL import Image

    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.transforms import get_transform
    from grit_tpu_torch.convert import load_reference_checkpoint
    from grit_tpu_torch.engine.evaluator import make_caption_generator
    from grit_tpu_torch.models.captioner import build_captioner, to_compute_dtype
    from grit_tpu_torch.utils.nested import batch_images

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    config = config or default_caption_config()
    beam = beam_size or config.model.beam_size
    lm_decoder = config.model.cap_generator.decoder_name == "mla_moe"
    text_field = None if lm_decoder else TextField(vocab_path=config.dataset.vocab_path)
    transform = get_transform(config.dataset.transform_cfg)["valid"]
    with Image.open(image_path) as im:
        arr = transform(im)
    batch = batch_images([arr], bucket_hw=tuple(config.dataset.transform_cfg.size))

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_captioner(config, device=device, dtype=dtype,
                            seed=None if checkpoint else 0)
    if checkpoint:
        model.load_state_dict(load_reference_checkpoint(checkpoint), strict=True)
        model = to_compute_dtype(model, dtype)
    generate = make_caption_generator(
        model, beam_size=beam, max_len=config.model.beam_len,
        bos_idx=config.model.bos_idx, eos_idx=config.model.eos_idx)
    out = generate(batch.to(device), 1).cpu().numpy()
    if text_field is None:
        return " ".join(str(int(i)) for i in out[0])
    return text_field.decode(out)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="a reference .pth; without it, the random weights of seed 0")
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--device", default="cuda")
    args, overrides = ap.parse_known_args(argv)

    from grit_tpu_torch.config import default_caption_config

    config = default_caption_config().apply_overrides(overrides)
    if args.vocab:
        config.dataset.vocab_path = args.vocab
    print(f"Caption: {caption_image(args.image, args.checkpoint, config, args.beam, args.device)}")


if __name__ == "__main__":
    main()
