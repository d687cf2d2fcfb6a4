"""The benchmark of sdrtrunk_tpu_torch's live device step (run.py)."""
