"""Share of the traced slice of the window in which no operation ran on
the device, %."""


def read(ctx, out):
    t = out.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
