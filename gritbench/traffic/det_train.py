"""Driver ``det_train``: detector pre-training steps through the port's
``detection.solver.make_detector_train_step``, issued back to back as the
trainer issues them, the losses read back every ``read_every`` steps.

Set-up builds the detection model, its five-group optimizer and the step on
the card, loads the benchmark's weights from the seed, and makes a pool of
image batches and padded targets from the seed (in pinned host memory; each
step copies its batch to the card).  The configuration computes in float32,
so TF32 is off for matmuls and cuDNN throughout the run.  Set-up then
drives that same training state through its first three steps
(``training.TrainRun.check_steps``); the window continues it.

The check: the float32 reference (``gritbench/reference/detection.py``)
runs the three steps from the same weights on the same batches with the
same dropout and drop-path masks, once the window has closed and the
program is freed; ``gritbench/training.py`` compares.
"""

from __future__ import annotations

import torch

from gritbench import harness, inputs, program, training
from gritbench.counts import detection as counts
from gritbench.reference import detection as ref_det
from gritbench.reference.nn import Arith, fp32_context, restore
from gritbench.weights import make_weights


def pool(traffic: dict, cfg: dict, seed: int, device) -> list[dict]:
    """``pool_batches`` batches drawn from the seed: images
    (``gritbench/inputs.py``) and padded targets: ``boxes`` boxes an image,
    uniform; classes uniform; boxes cxcywh inside the image's own frame,
    centres in ``box_center``, sides in ``box_size``."""
    b, g = traffic["batch"], traffic["max_boxes"]
    gen = inputs.generator(seed, 29, device)
    (lo, hi), (slo, shi) = traffic["box_center"], traffic["box_size"]
    out = []
    for _ in range(traffic["pool_batches"]):
        imgs, pad = inputs.images(traffic, gen, device)
        n = torch.randint(traffic["boxes"][0], traffic["boxes"][1] + 1, (b, 1), generator=gen,
                          device=device)
        u = torch.rand((b, g, 4), generator=gen, device=device)
        out.append(inputs.to_host({
            "images": imgs, "pad": pad,
            "labels": torch.randint(0, cfg["model"]["detector"]["num_classes"], (b, g),
                                    generator=gen, device=device, dtype=torch.int32),
            "boxes": torch.cat([lo + (hi - lo) * u[..., :2], slo + (shi - slo) * u[..., 2:]], -1),
            "valid": torch.arange(g, device=device)[None] < n}))
    return out


class DetRun(training.TrainRun):
    def build(self, seed: int) -> None:
        from grit_tpu_torch.detection import solver
        from grit_tpu_torch.detection.detector import build_detection_model
        from grit_tpu_torch.engine import optim, xe

        pc = program.detection_config(self.cfg)
        model, crit = build_detection_model(pc, None, device=self.device, seed=None)
        self.shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        model.load_state_dict(make_weights(self.shapes, seed, self.device,
                                           det=self.cfg["model"]["detector"]))
        o = pc.optimizer
        opt = optim.build_detector_optimizer(
            model, lr=o.lr, lr_backbone=o.lr_backbone, sp_lr=o.sp_lr,
            weight_decay=o.weight_decay, sp_names=list(o.sp_names))
        self.mask_seed = int(seed) + 1
        self.state = xe.TrainState(model, opt, global_steps=0, generator=torch.Generator(
            device=self.device).manual_seed(self.mask_seed))
        self.step = self.ranged(solver.make_detector_train_step(crit,
                                                                clip_max_norm=o.clip_max_norm))
        self.pool = pool(self.traffic, self.cfg, seed, self.device)

    def args(self, i: int):
        from grit_tpu_torch.utils.nested import ImageBatch

        b = self.pool[i % len(self.pool)]
        return (ImageBatch(b["images"], b["pad"]).to(self.device),
                {k: b[k].to(self.device, non_blocking=True) for k in ("labels", "boxes",
                                                                       "valid")})


def reference(cell: harness.Cell, shapes, batches, mask_seed: int, arith: str = "fp32",
              half: bool = False) -> dict:
    """The reference's three steps on ``batches`` (host dicts) -> the
    readings ``training.compare`` takes."""
    dev = torch.device(cell.device)
    w0 = make_weights(shapes, cell.seed, dev, det=cell.config["model"]["detector"])
    steps = [(b["images"].to(dev), b["pad"].to(dev),
              {k: b[k].to(dev) for k in ("labels", "boxes", "valid")}) for b in batches]
    prev = fp32_context()
    try:
        out = ref_det.train_steps(Arith(arith), w0, steps, cell.config, mask_seed, dev, half)
    finally:
        restore(prev)
    return training.reference_readings(out, w0)


def run(cell: harness.Cell) -> dict:
    prev = fp32_context()     # the configuration computes in float32: no TF32
    try:
        return training.run_cell(cell, DetRun(cell), counts, reference)
    finally:
        restore(prev)


def arm_inputs(cell: harness.Cell):
    """(the model's parameter shapes, the first three pool batches) for an
    arm that runs the reference alone."""
    from grit_tpu_torch.detection.detector import build_detection_model

    dev = torch.device(cell.device)
    model, _ = build_detection_model(program.detection_config(cell.config), None, device=dev,
                                     seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    return shapes, pool(cell.traffic, cell.config, cell.seed, dev)[:training.CHECK_STEPS]


def control(cell: harness.Cell) -> dict:
    """The control in the program's place: the reference's three steps with
    every product's operands rounded to TF32 (the precision below float32)."""
    return training.against_reference(cell, *arm_inputs(cell), reference, arith="tf32")


def fault(cell: harness.Cell) -> dict:
    """The fault of a step whose loss leaves out half of the batch, planted
    in the reference put in the program's place."""
    return training.against_reference(cell, *arm_inputs(cell), reference, half=True)
