"""Host ms a chunk the step's dispatch spends launching its work: the
program's ``dispatch`` spans less their ``h2d`` copies, with the
program's tracer on and the profiler off (``spans.host_ms``)."""


def read(run):
    from benchmark import spans

    return spans.host_ms(run, "dispatch", less="h2d")
