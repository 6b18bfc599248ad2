"""Set-up seconds: from the process's start to the window's, the import of
torch and the port, the card's start, the data, the compression of the
inputs, the upload and the warm-up (with a first build of the kernels)."""


def read(run):
    return run.setup_s
