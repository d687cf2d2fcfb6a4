"""Host arrays a chunk the step's dispatch copies to the device (the
program's ``h2d`` counter), with the program's tracer on and the
profiler off (``spans.per_chunk``)."""


def read(run):
    from benchmark import spans

    return spans.per_chunk(run, "h2d")
