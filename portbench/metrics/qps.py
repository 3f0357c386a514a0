"""Queries answered within the window, a second of the window."""


def read(ctx):
    w = ctx.window
    done = sum(1 for r in w.records if r.done <= w.end)
    return done / (w.end - w.start)
