"""Column generators, one module a kind, found by the `gen` key of a
configuration's column (portbench/datagen.py).  Each module has
``generate(spec, n, gen, cols, device) -> (n,) int64 tensor``: `gen` is the
chunk's torch.Generator, `cols` the columns made before this one."""
