"""The share (%) of the loop's time in which no kernel, copy or memset
runs on the device, as the loop runs untraced: one less the device's
busy seconds a chunk (the union of the device intervals over the traced
window, over its chunks) over the seconds a chunk of the untraced
window. The profiler slows the host's side of the loop, so the traced
window's own idle share (``window_s`` less ``busy_s``) reads higher."""


def read(run):
    t, w = run.trace, run.plain
    if t.busy_s() <= 0 or run.window.chunks == 0 or w.chunks == 0:
        return None
    busy = t.busy_s() / run.window.chunks
    period = (w.end - w.start) / w.chunks
    return 100.0 * (1.0 - busy / period)
