"""train_img_s: images trained a second, steps x batch over the whole
window, the loader in the loop."""

from perfbench import readers


def read(ctx):
    return readers.rate(ctx)
