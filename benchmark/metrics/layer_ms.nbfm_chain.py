"""Device ms of the step's nbfm_chain layer on one chunk, alone, from a copy of
the running state (CUDA events around three runs after one warm run)."""


def read(run):
    return run.layer_ms.get("nbfm_chain")
