"""Device ms a chunk of the DQPSK symbol kernel (csrc/dqpsk.cu), from the
profiler's kernel intervals over the traced window."""


def read(run):
    s = run.trace.seconds_matching("dqpsk_kernel")
    return 1e3 * s / run.window.chunks if s > 0 else None
