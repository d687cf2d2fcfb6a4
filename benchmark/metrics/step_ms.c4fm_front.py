"""Device ms a chunk of the C4FM front end (the program's
``step.c4fm_front`` spans) inside the running loop: the device's busy
intervals within the spans' device-side mirrors, in a profiled window
with the program's tracer on (``spans.step_ms``)."""


def read(run):
    from benchmark import spans

    return spans.step_ms(run, "c4fm_front")
