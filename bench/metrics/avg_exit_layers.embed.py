"""Vision layers run a photo in the window's drains (the engine's
``layers_executed`` over the photos embedded): the exit mix the
predictor gave, the superficial layers counted for an exit within
them."""


def read(rec):
    c = rec["counters"]
    return c["layers_executed"] / c["items"] if c["items"] else None
