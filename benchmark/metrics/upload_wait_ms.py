"""Host ms a chunk the upload stage waits for the pinned buffer's previous
copy to end (the program's ``upload.ring_wait`` spans), with the
program's tracer on and the profiler off (``spans.host_ms``)."""


def read(run):
    from benchmark import spans

    return spans.host_ms(run, "upload.ring_wait")
