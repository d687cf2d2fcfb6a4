"""The port stands alone: it imports no JAX and nothing of sdrtrunk_tpu,
and its kernel path never falls back.

* Every file of sdrtrunk_tpu_torch/, chip_smoke.py, bench_torch.py,
  tests/test_torch_cuda.py, tools/symbol_loop_split.py,
  tools/bit_timing_blocks.py and tools/recurrence_split.py is parsed, and no import of jax, of
  sdrtrunk_tpu or of any sdrtrunk_tpu.* module is allowed (the machine
  with the card has no JAX installed, and the port keeps its own copy of
  the host layer it needs: tests/test_torch_host_copy.py).
* A fresh interpreter imports every port module (the CLI, the monitor,
  the copied sources, service and application modules among them),
  chip_smoke and bench_torch, then
  drives the port's CPU Orchestrator for one chunk at a tiny width: the
  bank tier for c4fm, p25p2, lsm, dmr, nbfm, am, ltr and mpt1327 (the bank
  processors' lazy imports run there), the per-slot path for the six
  kinds that have one, banks= over six kinds, and host_process=True (its
  worker process spawned and stopped), and an AuxDecoder on a block of
  silence, then a per-channel C4FM decode saved and loaded as a
  checkpoint, the static ``build()`` over a single-bin and a two-bin
  channel, a CIC channel, the biquad, the CMA equalizer and a mixer;
  neither 'jax' nor any sdrtrunk_tpu module is in sys.modules after.
  ``python -m sdrtrunk_tpu_torch.cli --platform cpu playlist list`` and
  ``python -m sdrtrunk_tpu_torch.parity --platform cpu`` (which must pass
  on all three protocols) load neither either (their import logs, ``-X
  importtime``).
* The device rule: ``resolve_device(None)`` is ``default_device()``,
  "cuda" unless a ``use_device`` block, which restores it on exit (an
  exception included), says otherwise; an explicit device wins.
* batched() on a non-CPU tensor goes to the CUDA kernel, and so does
  bit_timing(); when the build fails, the call raises and the plain loop
  is never run. The shared nvcc helper raises when nvcc fails, and leaves
  no library behind, and the input check the wrappers share refuses a
  tensor of the wrong device, dtype, shape or layout.
* The phase-split tools' text edits still find their places in
  csrc/bit_timing.cu, csrc/biquad.cu and csrc/cma.cu.
"""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sdrtrunk_tpu_torch.dsp import (bit_timing, bit_timing_cuda, dqpsk_cuda,
                                    gardner_cuda, nvcc)
from sdrtrunk_tpu_torch.dsp.afsk import AFSK1200Demodulator
from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator
from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator, DQPSKState,
                                        GardnerDQPSKDemodulator, GardnerState)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sdrtrunk_tpu_torch"
REFERENCE = ROOT / "sdrtrunk_tpu"
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)


def _jax_modules() -> set[str]:
    """Dotted names of the reference modules whose source imports jax."""
    mods = set()
    for path in REFERENCE.rglob("*.py"):
        if _JAX_IMPORT.search(path.read_text()):
            rel = path.relative_to(ROOT).with_suffix("")
            name = ".".join(rel.parts)
            mods.add(name[:-len(".__init__")] if name.endswith(".__init__")
                     else name)
    return mods


def _port_files() -> list[Path]:
    # test_torch_cuda.py and the tools run on the card's machine, which has
    # no JAX; tools/reference_digests.py is left out: it runs the JAX
    # package on the CPU by design, to write the digests the card is held to
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "bench_torch.py",
                                         ROOT / "tests" / "test_torch_cuda.py",
                                         ROOT / "tools" / "symbol_loop_split.py",
                                         ROOT / "tools" / "bit_timing_blocks.py",
                                         ROOT / "tools" / "recurrence_split.py"]


def _imported(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


def test_reference_module_list_is_known():
    mods = _jax_modules()
    assert "sdrtrunk_tpu.receiver" in mods
    assert "sdrtrunk_tpu.dsp.psk" in mods
    assert "sdrtrunk_tpu.runtime.bank_processor" not in mods


def _foreign(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "sdrtrunk_tpu"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    with_jax = _jax_modules()
    for name in _imported(ast.parse(path.read_text(), str(path))):
        assert not _foreign(name), \
            f"{path.name} imports {name}" + (
                ", which imports jax" if name in with_jax else "")


def test_block_sweep_tool_finds_its_marker():
    """tools/bit_timing_blocks.py builds a clock64 copy of
    csrc/bit_timing.cu by text edits around the kernel's three phases
    (pack, walk, write); each marker must be there, once, and the copy
    keeps the C entry point the wrapper's argument types describe. The
    kernel's shape is fixed by its source: the wrapper passes no block,
    tile or warp count."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bit_timing_blocks", ROOT / "tools" / "bit_timing_blocks.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (nvcc.CSRC / "bit_timing.cu").read_text()
    for phase in ("pack", "walk", "write"):
        assert text.count(f"    // --- {phase}\n") == 1
    copy = tool.instrument(text)
    assert copy.count("clock64()") == 4 and "read_clk" in copy
    assert copy.count("extern \"C\" int bit_timing_launch(") == 1
    assert "kBlock" not in text
    assert len(bit_timing_cuda._ARGTYPES) == 19


@pytest.mark.parametrize("kernel,phases,clocks", [
    ("biquad", ("start", "stage", "walk", "store", "next", "end"), 5),
    ("cma", ("start", "products", "error", "clip", "update", "next", "end"),
     6)])
def test_recurrence_split_tool_finds_its_markers(kernel, phases, clocks):
    """tools/recurrence_split.py builds a clock64 copy of csrc/biquad.cu
    and csrc/cma.cu by text edits at the kernels' phase markers (the
    ``// --- name`` comments), each there once, and a variant of each by
    one edit of a constant that must be there once; the copies keep the C
    entry point the wrapper's argument types describe."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "recurrence_split", ROOT / "tools" / "recurrence_split.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (nvcc.CSRC / f"{kernel}.cu").read_text()
    for phase in phases:
        assert len(re.findall(rf"^ *// --- {phase}\n", text, re.M)) == 1
    copy = tool.instrument(kernel, text)
    assert copy.count("clock64()") == clocks and "read_clk" in copy
    assert copy.count(f'extern "C" int {kernel}_launch(') == 1
    for old, _ in tool._VARIANTS[kernel].values():
        assert text.count(old) == 1
    with pytest.raises(ValueError, match="no edit set"):
        tool.instrument(kernel, text.replace("// --- walk", "").replace(
            "// --- error", ""))


_DRIVE = """
import sys
import numpy as np
from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator


def drive(chunk, **kw):
    orch = Orchestrator(lambda n: None, 64 * 12500.0, 460e6, [25000.0],
                        chunk_samples=chunk, ppm_correction=False,
                        device="cpu", **kw)
    try:
        m = orch.run_chunk(np.zeros((chunk, 2), np.int8))
    finally:
        orch.close()
    assert m["samples"] == chunk, m
    return orch


for kind in ("c4fm", "p25p2", "lsm", "dmr", "nbfm", "am", "ltr", "mpt1327"):
    # the analog kinds resample 25 kHz to 8 kHz: K = 2 * chunk / M must
    # be a multiple of 25, and for mpt1327 the audio length one of 10
    chunk = (64 * 25 * 2 if kind in ("nbfm", "am") else
             64 * 125 if kind in ("ltr", "mpt1327") else 64 * 64)
    drive(chunk, slots=4, decoder=kind, bank_mode=True)
    if kind not in ("ltr", "mpt1327"):                 # the per-slot path
        assert not drive(chunk, slots=4, decoder=kind).bank_mode
drive(64 * 125, banks=[("c4fm", 2), ("dmr", 1), ("ltr", 1), ("nbfm", 1),
                       ("mpt1327", 1), ("p25p2", 1)])
drive(64 * 64, slots=4, bank_mode=True, host_process=True)
from sdrtrunk_tpu_torch.decoders.auxdec import AuxDecoder
assert AuxDecoder("fleetsync2", device="cpu").process(np.zeros(800)) == []

import os
import tempfile
import torch
from sdrtrunk_tpu_torch.decoders.c4fm import C4FMDecoder
from sdrtrunk_tpu_torch.dsp import cic, misc, oscillator
from sdrtrunk_tpu_torch.receiver import WidebandReceiver
from sdrtrunk_tpu_torch.runtime.checkpoint import load_state, save_state
dec = C4FMDecoder(device="cpu")                 # the per-channel call
_, st = dec(torch.zeros(300, dtype=torch.complex64), dec.init_state())
with tempfile.TemporaryDirectory() as tmp:
    save_state(os.path.join(tmp, "s.npz"), st)
    load_state(os.path.join(tmp, "s.npz"), dec.init_state())
rx = WidebandReceiver(64 * 12500.0, [0.0, 18750.0], decoder="nbfm",
                      channel_bandwidths=[12500.0, 25000.0], device="cpu")
rx.build()(torch.zeros(64 * 50, dtype=torch.complex64), rx.init_state())
cic.CICChannel.design(2.4e6, 3e5, 25e3, device="cpu")(
    torch.zeros(96 * 4, dtype=torch.complex64))
misc.biquad_apply(torch.zeros(10), *misc.biquad_design("lowpass", 1e3, 8e3))
misc.cma_equalize(torch.zeros(10, dtype=torch.complex64))
oscillator.mix_down(torch.zeros(10, dtype=torch.complex64), 100.0, 8000.0)
"""


def test_fresh_interpreter_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\nimport bench_torch\n" + _DRIVE
            + "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'sdrtrunk_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_module_loads_no_jax(tmp_path):
    from sdrtrunk_tpu_torch.config import (ChannelConfig, DecodeConfig,
                                           Playlist, SourceConfig)
    path = tmp_path / "p.json"
    Playlist(channels=[ChannelConfig(
        name="Ctrl", source=SourceConfig(frequency_hz=460_025_000.0),
        decode=DecodeConfig(decoder="p25p1"))]).save(path)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "sdrtrunk_tpu_torch.cli",
         "--platform", "cpu", "playlist", "list", "--playlist", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert '"name": "Ctrl"' in proc.stdout
    loaded = [line.rsplit("|", 1)[-1].strip()
              for line in proc.stderr.splitlines()
              if line.startswith("import time:")]
    assert "sdrtrunk_tpu_torch.config" in loaded      # the log is read
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "sdrtrunk_tpu")]
    assert not bad, bad


def test_parity_main_runs_on_the_cpu_without_jax():
    """``python -m sdrtrunk_tpu_torch.parity --platform cpu`` passes the
    reference's rule on all three protocols (one JSON line each, exit 0)
    and loads neither jax nor sdrtrunk_tpu (its import log)."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "sdrtrunk_tpu_torch.parity",
         "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert len(rows) == 3 and all(r["events_match"] for r in rows)
    loaded = [line.rsplit("|", 1)[-1].strip()
              for line in proc.stderr.splitlines()
              if line.startswith("import time:")]
    assert "sdrtrunk_tpu_torch.decoders.c4fm" in loaded      # the log is read
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "sdrtrunk_tpu")]
    assert not bad, bad


def test_device_rule():
    import sdrtrunk_tpu_torch as port
    assert port.default_device() == "cuda"
    with port.use_device("cpu"):
        assert port.resolve_device(None) == torch.device("cpu")
        assert port.resolve_device("meta") == torch.device("meta")
        with port.use_device("meta"):
            assert port.default_device() == "meta"
        assert port.default_device() == "cpu"
    assert port.default_device() == "cuda"
    with pytest.raises(KeyError):
        with port.use_device("cpu"):
            raise KeyError("inside")
    assert port.default_device() == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port.resolve_device(None)


def test_kernel_build_failure_raises_without_fallback(monkeypatch):
    demod = DQPSKDemodulator(25000.0, device="cpu")
    c = 2
    state = DQPSKState(*[a.expand((c,) + a.shape).clone().to("meta")
                         for a in demod.init_state()])
    x = torch.zeros((c, 16), dtype=torch.complex64, device="meta")

    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    def plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a non-CPU tensor")

    monkeypatch.setattr(dqpsk_cuda, "build", fail)
    monkeypatch.setattr(DQPSKDemodulator, "scan_batched", plain)
    monkeypatch.setattr(DQPSKDemodulator, "scan_packed", plain)
    before = dqpsk_cuda.dqpsk_cuda.launches
    with pytest.raises(BuildFailed):
        demod.batched(x, state)
    assert dqpsk_cuda.dqpsk_cuda.launches == before


def test_kernel_wrapper_rejects_a_cpu_tensor(monkeypatch):
    monkeypatch.setattr(dqpsk_cuda, "build", lambda: None)
    demod = DQPSKDemodulator(25000.0, device="cpu")
    state = DQPSKState(*[a.expand((1,) + a.shape).clone()
                         for a in demod.init_state()])
    with pytest.raises(ValueError, match="CUDA"):
        dqpsk_cuda.dqpsk_cuda(demod, torch.zeros((1, 8), dtype=torch.complex64),
                              state)


def test_cuda_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DQPSKDemodulator(25000.0)


def test_gardner_kernel_build_failure_raises_without_fallback(monkeypatch):
    demod = GardnerDQPSKDemodulator(25000.0, device="cpu")
    c = 2
    state = GardnerState(*[a.expand((c,) + a.shape).clone().to("meta")
                           for a in demod.init_state()])
    x = torch.zeros((c, 16), dtype=torch.complex64, device="meta")

    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    def plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a non-CPU tensor")

    monkeypatch.setattr(gardner_cuda, "build", fail)
    monkeypatch.setattr(GardnerDQPSKDemodulator, "scan_batched", plain)
    monkeypatch.setattr(GardnerDQPSKDemodulator, "scan_packed", plain)
    before = gardner_cuda.gardner_cuda.launches
    with pytest.raises(BuildFailed):
        demod.batched(x, state)
    assert gardner_cuda.gardner_cuda.launches == before


def test_gardner_wrapper_rejects_a_window_without_instantiation(monkeypatch):
    """The kernel is instantiated for every W up to 128 (a lane layout
    each); above it the wrapper raises before building."""
    monkeypatch.setattr(gardner_cuda, "build", lambda: None)
    demod = GardnerDQPSKDemodulator(312000.0, device="cpu")     # W = 130
    state = GardnerState(*[a.expand((1,) + a.shape).clone()
                           for a in demod.init_state()])
    with pytest.raises(ValueError, match=r"W = 130 .*\[8, 128\]"):
        gardner_cuda.gardner_cuda(
            demod, torch.zeros((1, 8), dtype=torch.complex64), state)


@pytest.mark.parametrize("demod_cls,invert", [
    (LTRFSKDemodulator, False), (AFSK1200Demodulator, True)],
    ids=["fsk", "afsk"])
def test_bit_timing_build_failure_raises_without_fallback(monkeypatch,
                                                          demod_cls, invert):
    """Both demodulators' public call sends a non-CPU tensor to the
    bit-timing kernel; a failed build raises, and the plain loop does not
    run in its place."""
    kw = {"invert": True} if invert else {}
    demod = demod_cls(device="cpu", **kw)
    geom = demod.geometry
    x = torch.zeros((2, 40), dtype=torch.float32, device="meta")
    window = torch.zeros((2, geom.window_len), dtype=torch.int8,
                         device="meta")
    sp = torch.zeros((2,), dtype=torch.float32, device="meta")

    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    def plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a non-CPU tensor")

    monkeypatch.setattr(bit_timing_cuda, "build", fail)
    monkeypatch.setattr(bit_timing, "bit_timing_plain", plain)
    before = bit_timing_cuda.bit_timing_cuda.launches
    with pytest.raises(BuildFailed):
        bit_timing.bit_timing(geom, x, window, sp, invert)
    assert bit_timing_cuda.bit_timing_cuda.launches == before


def test_bit_timing_wrapper_rejects_a_cpu_tensor(monkeypatch):
    monkeypatch.setattr(bit_timing_cuda, "build", lambda: None)
    geom = LTRFSKDemodulator(device="cpu").geometry
    with pytest.raises(ValueError, match="CUDA"):
        bit_timing_cuda.bit_timing_cuda(
            geom, torch.zeros((1, 8)), torch.zeros((1, 53), dtype=torch.int8),
            torch.zeros((1,)))


@pytest.mark.parametrize("name", ["dqpsk", "gardner", "bit_timing", "biquad",
                                  "cma"])
def test_nvcc_failure_raises_and_leaves_no_library(monkeypatch, tmp_path,
                                                   name):
    """The shared build helper runs nvcc once per source and raises with
    nvcc's message when it fails; nothing is loaded."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="no card here"):
        nvcc.load_kernel(name, f"{name}_launch", [])
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("case", [
    "dtype", "complex_coefficients", "cpu_rows", "cpu_stream", "taps",
    "no_taps", "two_d", "window"])
def test_recurrence_wrappers_refuse_before_building(monkeypatch, case):
    """The biquad, CMA and bit-timing wrappers refuse what their kernels do
    not take with ValueError before they build: a float64 row, complex
    coefficients, a CPU tensor (``biquad_apply`` and ``cma_equalize``
    never send one), more than 32 taps or none, a 2-D stream, and a delay
    line above 512."""
    from sdrtrunk_tpu_torch.dsp import biquad_cuda, cma_cuda

    def fail():
        raise AssertionError("built before refusing")

    for mod in (biquad_cuda, cma_cuda, bit_timing_cuda):
        monkeypatch.setattr(mod, "build", fail)
    b, a = [0.2, 0.4, 0.2], [1.0, -0.5, 0.25]
    x = torch.zeros((3, 16), device="meta")
    z = torch.zeros(16, dtype=torch.complex64, device="meta")
    call, match = {
        "dtype": (lambda: biquad_cuda.biquad_cuda(x.double(), b, a),
                  "float32 or complex64"),
        "complex_coefficients": (lambda: biquad_cuda.biquad_cuda(
            x, [0.2, 0.4 + 0.1j, 0.2], a), "three real coefficients"),
        "cpu_rows": (lambda: biquad_cuda.biquad_cuda(
            torch.zeros((3, 16)), b, a), "CUDA"),
        "cpu_stream": (lambda: cma_cuda.cma_cuda(
            torch.zeros(16, dtype=torch.complex64), torch.ones(11)), "CUDA"),
        "taps": (lambda: cma_cuda.cma_cuda(z, torch.ones(33, device="meta")),
                 "33 taps"),
        "no_taps": (lambda: cma_cuda.cma_cuda(
            z, torch.ones(0, device="meta")), "0 taps"),
        "two_d": (lambda: cma_cuda.cma_cuda(
            z[None], torch.ones(11, device="meta")), "1-D"),
        "window": (lambda: bit_timing_cuda.bit_timing_cuda(
            LTRFSKDemodulator(sample_rate=80000.0, device="cpu").geometry,
            x, torch.zeros((3, 533), dtype=torch.int8),
            torch.zeros(3)), "W = 533 .*above the kernel's 512"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("case", ["device", "dtype", "shape", "layout"])
def test_shared_input_check_refuses_what_a_kernel_does_not_take(case):
    good = torch.zeros((4, 3), dtype=torch.complex64)
    bad = {"device": good.to("meta"),
           "dtype": good.to(torch.complex128),
           "shape": good[:2],
           "layout": torch.zeros((3, 4), dtype=torch.complex64).T}[case]
    nvcc.check_tensor("k", "x", good, torch.complex64, (4, 3), good.device)
    with pytest.raises(ValueError, match="k: x must be a contiguous"):
        nvcc.check_tensor("k", "x", bad, torch.complex64, (4, 3), good.device)
