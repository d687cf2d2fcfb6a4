"""Device ms a chunk of ingest and the channelizer (the program's
``step.channelize`` spans) inside the running loop: the device's busy
intervals within the spans' device-side mirrors, in a profiled window
with the program's tracer on (``spans.step_ms``)."""


def read(run):
    from benchmark import spans

    return spans.step_ms(run, "channelize")
