"""Driver ``xe_train``: cross-entropy training steps of the captioner through
the port's ``engine.xe.make_xe_train_step``, issued back to back as the XE
loop issues them, the losses kept on the card and read back every
``read_every`` steps.

Set-up builds the captioner for training (float32 master parameters
computing in the configuration's type, dropouts on, the configuration's
frozen Swin stages), its two-group Adam and the step; loads the benchmark's
weights from the seed; makes a pool of image batches and captions from the
seed (``caption_tokens`` words between BOS and EOS, padded to the batch's
longest as the text field pads them); and drives the state through its
first three steps (``training.TrainRun.check_steps``).  The window
continues the same state.

The check: the float32 reference (``gritbench/reference/xe.py``) runs the
three steps from the same weights on the same batches with the same masks,
once the window has closed and the program is freed.
"""

from __future__ import annotations

import torch

from gritbench import harness, inputs, program, training
from gritbench.counts import xe as counts
from gritbench.reference import xe as ref_xe
from gritbench.reference.nn import Arith, fp32_context, restore
from gritbench.weights import make_weights

def pool(traffic: dict, cfg: dict, seed: int, device) -> list[dict]:
    """``pool_batches`` batches drawn from the seed: images
    (``gritbench/inputs.py``) and captions [B, L] of uniform lengths in
    ``caption_tokens`` (the first row of each batch the longest, so L is the
    longest + 2), words uniform over the vocabulary past its four special
    tokens."""
    m = cfg["model"]
    b = traffic["batch"]
    lo, hi = traffic["caption_tokens"]
    gen = inputs.generator(seed, 41, device)
    out = []
    for _ in range(traffic["pool_batches"]):
        imgs, pad = inputs.images(traffic, gen, device)
        n = torch.randint(lo, hi + 1, (b,), generator=gen, device=device)
        n[0] = hi
        words = torch.randint(4, m["vocab_size"], (b, hi), generator=gen, device=device)
        pos = torch.arange(1, hi + 1, device=device)[None]
        caps = torch.full((b, hi + 2), m["pad_idx"], dtype=torch.long, device=device)
        caps[:, 0] = m["bos_idx"]
        caps[:, 1:hi + 1] = torch.where(pos <= n[:, None], words, m["pad_idx"])
        caps.scatter_(1, (n + 1)[:, None], m["eos_idx"])
        out.append(inputs.to_host({"images": imgs, "pad": pad, "captions": caps}))
    return out


class XERun(training.TrainRun):
    def build(self, seed: int) -> None:
        from grit_tpu_torch.engine import optim, xe
        from grit_tpu_torch.models.captioner import build_captioner

        m, o = self.cfg["model"], self.cfg["optimizer"]
        model = build_captioner(program.caption_config(self.cfg), device=self.device,
                                dtype=program.DTYPES[self.cfg["dtype"]], seed=None, train=True)
        self.shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        model.load_state_dict(make_weights(self.shapes, seed, self.device, det=m["detector"]))
        freeze = optim.frozen_mask(model, optim.swin_frozen_stages_predicate(m["frozen_stages"]))
        opt = optim.build_optimizer(model, model_lr=o["schedule"]["init_lr"],
                                    backbone_lr=o["backbone_lr"], beta_1=o["beta1"],
                                    beta_2=o["beta2"], freeze=freeze)
        self.mask_seed = int(seed) + 1
        self.state = xe.TrainState(model, opt, global_steps=o["first_step"],
                                   generator=torch.Generator(device=self.device).manual_seed(
                                       self.mask_seed))
        self.step = self.ranged(xe.make_xe_train_step(
            pad_idx=m["pad_idx"], sched_cfg=o["schedule"], backbone_lr=o["backbone_lr"]))
        self.pool = pool(self.traffic, self.cfg, seed, self.device)

    def args(self, i: int):
        from grit_tpu_torch.utils.nested import ImageBatch

        b = self.pool[i % len(self.pool)]
        return ({"samples": ImageBatch(b["images"], b["pad"]).to(self.device),
                 "captions": b["captions"].to(self.device, non_blocking=True)},)


def reference(cell: harness.Cell, shapes, batches, mask_seed: int, arith: str = "fp32",
              half: bool = False) -> dict:
    dev = torch.device(cell.device)
    w0 = make_weights(shapes, cell.seed, dev, det=cell.config["model"]["detector"])
    steps = [(b["images"].to(dev), b["pad"].to(dev), b["captions"].to(dev)) for b in batches]
    prev = fp32_context()
    try:
        out = ref_xe.train_steps(Arith(arith), w0, steps, cell.config, mask_seed, dev,
                                 first_step=cell.config["optimizer"]["first_step"], half=half)
    finally:
        restore(prev)
    return training.reference_readings(out, w0)


def run(cell: harness.Cell) -> dict:
    return training.run_cell(cell, XERun(cell), counts, reference)


def arm_inputs(cell: harness.Cell):
    """(the model's parameter shapes, the first three pool batches) for an
    arm that runs the reference alone."""
    from grit_tpu_torch.models.captioner import build_captioner

    dev = torch.device(cell.device)
    model = build_captioner(program.caption_config(cell.config), device=dev, dtype=torch.float32,
                            seed=None, train=True)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    return shapes, pool(cell.traffic, cell.config, cell.seed, dev)[:training.CHECK_STEPS]


def control(cell: harness.Cell) -> dict:
    """The control in the program's place: the reference's three steps with
    every product's operands in float8 e4m3 (the precision below the
    configuration's bfloat16)."""
    return training.against_reference(cell, *arm_inputs(cell), reference, arith="fp8")


def fault(cell: harness.Cell) -> dict:
    """The fault of a step whose loss leaves out half of the batch, planted
    in the reference put in the program's place."""
    return training.against_reference(cell, *arm_inputs(cell), reference, half=True)
