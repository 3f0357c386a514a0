"""Seconds from the process's start to the window's: imports, the card's
start, making and packing the table, handing it to the port, building the
kernels (a first run), uploading the mirrors and the warm-up queries."""


def read(ctx):
    return ctx.setup_s
