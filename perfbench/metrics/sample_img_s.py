"""sample_img_s: images a second, each drift call worth images / (num_steps
- 1) of an image, over the whole window from its first call to the
synchronise after its last."""

from perfbench import readers


def read(ctx):
    return readers.rate(ctx)
