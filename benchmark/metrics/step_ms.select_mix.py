"""Device ms a chunk of the slot select and mix (the program's
``step.select_mix`` spans) inside the running loop: the device's busy
intervals within the spans' device-side mirrors, in a profiled window
with the program's tracer on (``spans.step_ms``)."""


def read(run):
    from benchmark import spans

    return spans.step_ms(run, "select_mix")
