"""Host ms a chunk spends queueing its work: the upload stage (staging
into the pinned ring and the asynchronous copy's launch) plus the
dispatch stage (launching the step), each the mean over the untraced
window (the profiler slows both), by the host clock, with no
synchronisation inside."""


def read(run):
    w = run.plain
    if not w.upload_s or not w.dispatch_s:
        return None
    return 1e3 * (sum(w.upload_s) / len(w.upload_s)
                  + sum(w.dispatch_s) / len(w.dispatch_s))
