"""The ingest and channelizer layer's share (%) of its roofline: the
least time its bytes or operations allow (roofline.channelize_ms) over
its device ms on one chunk (layer_ms.channelize)."""


def read(run):
    from benchmark import roofline

    ms = run.layer_ms.get("channelize")
    if not ms:
        return None
    cfg = run.config
    return 100.0 * roofline.channelize_ms(
        run.replay.chunk_samples, cfg["channels"],
        cfg["taps_per_branch"]) / ms
