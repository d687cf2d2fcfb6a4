"""Host ms a chunk of the upload stage's staging copy into the pinned ring
(the program's ``upload.stage`` spans), with the program's tracer on and
the profiler off (``spans.host_ms``)."""


def read(run):
    from benchmark import spans

    return spans.host_ms(run, "upload.stage")
