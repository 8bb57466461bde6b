"""``build_index`` by the host clock, synchronised on both sides: the
float stages' fits, the encode and, for IVF, k-means and the list
assignment (moves ``setup_s``)."""


def read(ctx):
    return ctx.setup.get("build_s")
