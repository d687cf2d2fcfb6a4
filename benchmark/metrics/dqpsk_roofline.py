"""The DQPSK kernel's share (%) of its roofline: the least time its
bytes or operations allow (roofline.dqpsk_ms) over its device ms a
chunk."""


def read(run):
    from benchmark import roofline

    s = run.trace.seconds_matching("dqpsk_kernel")
    if s <= 0:
        return None
    ms = 1e3 * s / run.window.chunks
    c, t = len(run.replay.bins), run.replay.channel_samples
    dec = run.config["decoder"]
    sps = 2.0 * run.config["sample_rate_hz"] / run.config["channels"] \
        / dec["symbol_rate"]
    return 100.0 * roofline.dqpsk_ms(c, t, int(2 * sps), sps) / ms
