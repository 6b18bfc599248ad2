"""Host microseconds a batch, from its first call into the port to the
return of its last, before any wait: argument checks, allocation and the
ctypes launches of the op wrappers; the total of the untraced window, where
no profiler sits inside the calls, over its batches."""


def read(run):
    if run.direction != "encode" or not run.batches:
        return None
    return run.enqueue_s / run.batches * 1e6
