"""Device ms a chunk of host-to-device copies (the chunk's upload from
the pinned ring): the profiler's copy intervals over the traced window,
over the chunks it drove."""


def read(run):
    s = run.trace.seconds_matching("memcpy", "htod")
    return 1e3 * s / run.window.chunks if s > 0 else None
