"""Host ms a chunk the step's dispatch spends copying host arrays to the
device, each copy from pageable memory ending in a stream synchronise
(the program's ``h2d`` spans), with the program's tracer on and the
profiler off (``spans.host_ms``)."""


def read(run):
    from benchmark import spans

    return spans.host_ms(run, "h2d", absent=0.0)
