"""image_ms: the window's milliseconds over the images restored in it
(closed loop, host clock): the mean time a user waits for an image."""


def read(ctx):
    w = ctx.window
    if ctx.entry.unit != "images" or w.units <= 0:
        return None
    return 1e3 * w.seconds / w.units
