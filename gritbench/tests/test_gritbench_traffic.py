"""The caption traffic: the same seed gives the same inputs, another seed
others; the pool keeps the mix's image sizes."""

from __future__ import annotations

import torch

from gritbench.tests.tiny import CAPTION_TRAFFIC, caption_cell


def pool(seed):
    cell = caption_cell()
    return cell.driver.image_pool(CAPTION_TRAFFIC, seed, "cpu")


def test_same_seed_same_images():
    a, b = pool(2 ** 31 + 5), pool(2 ** 31 + 5)
    for x, y in zip(a, b):
        assert torch.equal(x.images, y.images) and torch.equal(x.mask, y.mask)


def test_other_seed_other_images():
    a, b = pool(7), pool(8)
    assert not torch.equal(a[0].images, b[0].images)


def test_sizes_and_padding():
    p = pool(1)
    assert len(p) == CAPTION_TRAFFIC["pool_batches"]
    for batch in p:
        for i in range(batch.images.shape[0]):
            h, w = CAPTION_TRAFFIC["image_sizes"][i % 2]
            assert int((~batch.mask[i]).sum()) == h * w
            assert int(batch.images[i][batch.mask[i]].abs().sum()) == 0


def test_weights_follow_the_seed():
    from gritbench.weights import make_weights

    shapes = [("a.weight", (4, 3)), ("a.bias", (4,)), ("n.weight", (4,))]
    w1, w2 = make_weights(shapes, 9, "cpu"), make_weights(shapes, 9, "cpu")
    w3 = make_weights(shapes, 10, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert float((w1["n.weight"] - 1).abs().max()) <= 0.1
    assert float(w1["a.bias"].abs().max()) <= 0.02
