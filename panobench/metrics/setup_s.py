"""Set-up: from the process's start to the window's (imports, CUDA, the
kernels, the photo sets, the cold panorama)."""


def read(ctx):
    return ctx.setup_s
