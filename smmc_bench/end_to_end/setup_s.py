"""Set-up seconds: from the harness's start (before torch is imported)
through the port's import, the CUDA context, the kernel library's load
(its build in a fresh checkout) and one warm-up query at the cell's
shapes."""


def read(rec):
    return rec.setup_s
