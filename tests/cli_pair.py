"""Run the JAX package's CLI and the port's on the same arguments, each
with --platform cpu, in this process; shared by tests/test_torch_cli*.py
and tests/test_torch_monitor.py."""
import contextlib
import io
import json

from sdrtrunk_tpu import cli as ref_cli
from sdrtrunk_tpu_torch import cli as port_cli


def run(module, argv) -> list:
    """stdout lines of `module`'s main on --platform cpu + argv; raises
    unless it exits 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(["--platform", "cpu", *[str(a) for a in argv]])
    assert rc == 0, (module.__name__, argv)
    return out.getvalue().splitlines()


def both(argv_ref, argv_port=None) -> tuple[list, list]:
    """(reference lines, port lines); argv_port defaults to argv_ref."""
    return (run(ref_cli, argv_ref),
            run(port_cli, argv_ref if argv_port is None else argv_port))


def rows(lines) -> list:
    return [json.loads(line) for line in lines]
