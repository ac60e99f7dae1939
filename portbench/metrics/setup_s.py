"""setup_s: seconds from the process's start to the window's first call (imports, kernel
build or load, weights, prompt embeddings, warm-up of the cell's shapes)."""


def read(r):
    return r.setup_s
