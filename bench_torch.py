"""Benchmark of the PyTorch/CUDA port: wideband IQ megasamples/s on one
CUDA card through channelize + demod (port of bench.py, function for
function).

Two flagship configs, both end-to-end numbers of the port's
``WidebandReceiver.build()``:
  * NBFM: 12.8 MS/s wideband -> 1024 x 12.5 kHz channels -> polyphase
    channelize -> extract all 1023 usable bins -> batched NBFM demod
    (FIR + squelch + discriminator + de-emphasis + 8 kHz resample) -> audio
  * C4FM: the same front end -> the DQPSK symbol-recovery kernel
    (csrc/dqpsk.cu) over all 1023 channels -> dibits

Timing: iterations are state-chained (each step consumes the previous
state), the host clock runs around work that ends in
``torch.cuda.synchronize()``, and a real output slice is pulled to the host
after the loop.

The 1023-slot bank legs are a scene builder each (``scene_*``: bench.py's
bytes, synthesized on the host as bench.py synthesizes them, and a ready
Orchestrator) and ``run_bank``, which runs and times it.
Five more of chip_smoke.py's live cells (LTR, MPT1327, LSM, AM, C4FM on
25 kHz channels) are ``cell_bytes`` (their bytes, built on the host, and
the recipe either package's Orchestrator is built from,
``orchestrator_from_recipe``) and ``scene_bank_<cell>`` on the port.
``bank_digest`` digests what a bank decoded in a form both packages give,
and ``compare_digests`` holds it to the JAX package's
(tests/torch_reference/banks_1023.json and cells_full_width.json;
``chip_smoke.py reference``).

Prints the full JSON line, then the headline (bench.py's keys, with
``live_c4fm_h2d_mbps`` for its ``live_c4fm_tunnel`` and
``nvlink_predicted_efficiency`` for its ``ici_predicted_efficiency``) as
the last line. Exits 1 after printing if any leg recorded an error.

Modes:
  bench_torch.py              full bench on the CUDA card (raises without
                              one) + the CPU scaling and cross-process legs
  bench_torch.py --small      quick CPU variant (runs on the CPU: the
                              kernels' plain versions)
  bench_torch.py --profile    also write a torch.profiler Chrome trace of
                              the NBFM leg under
                              $TMPDIR/sdrtrunk_tpu_torch_trace
  bench_torch.py --smoke      kernel-family smoke: each family once on the
                              card and once on the CPU, compared (raises
                              without a card)
  bench_torch.py --scaling-worker  (internal) gloo scaling measurement

Run it as ``python -m sdrtrunk_tpu_torch.cli bench [--small] [--trace]``
or directly from the repository root. It imports torch, numpy and
sdrtrunk_tpu_torch only.
"""
import contextlib
import enum
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# ------------------------------------------------------------- roofline

# NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 outside the tensor cores
# (the port turns TF32 off at import, so no float32 work reaches them) and
# 3.35 TB/s HBM3.
PEAK_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def roofline_nbfm(rx, msps: float) -> dict:
    """Analytic flops and bytes per wideband input sample for the NBFM
    config, bench.py's counts (complex MAC = 8 real flops):
      channelizer  : M branches x T-tap complex FIR per M/2 inputs
                     -> 2*T cmacs/sample, + IFFT ~ 5*M*log2 M real flops
                     per block -> 10*log2(M)/sample
      extraction   : C gathers + residual mixer (exp+cmul ~ 22 flops) at
                     2C/M channel-samples per input sample
      NBFM chain   : 63-tap complex baseband FIR + discriminator (~14) +
                     squelch power (4) + deemphasis IIR (4) + polyphase
                     resample to 8 kHz (12 taps at 8k/channel-rate)
    The peaks are the H100 SXM's (``PEAK_FLOPS``, ``PEAK_HBM_BPS``); at
    about 19 flops a byte the work sits far below the ridge, so its
    ceiling is the memory rate."""
    ch = rx.channelizer
    m = ch.channels
    t = ch.taps_per_channel
    c = rx.num_channels
    ch_rate_ratio = 2.0 * c / m          # channel-samples per input sample

    f_chan = 2.0 * t * 8 + 10.0 * np.log2(m)
    f_extract = ch_rate_ratio * 22.0
    per_ch = 63 * 8 + 14 + 4 + 4 + 12 * 2 * (8000.0 / ch.channel_sample_rate)
    f_demod = ch_rate_ratio * per_ch
    flops_per_sample = float(f_chan + f_extract + f_demod)

    # bytes: input sample (8 B complex64) + channelizer write+read of the
    # (K, M) bin matrix (2 channel-samples/input @ 8 B each way) +
    # per-channel stream write+read
    bytes_per_sample = float(8 + 2 * 8 * 2 + ch_rate_ratio * 8 * 2)

    achieved_flops = msps * 1e6 * flops_per_sample
    card = _card()
    return {
        "flops_per_sample": flops_per_sample,
        "bytes_per_sample": bytes_per_sample,
        "achieved_gflops": achieved_flops / 1e9,
        "achieved_gbps": msps * 1e6 * bytes_per_sample / 1e9,
        "arithmetic_intensity": flops_per_sample / bytes_per_sample,
        "ridge_intensity": PEAK_FLOPS / PEAK_HBM_BPS,
        "mfu": achieved_flops / PEAK_FLOPS,
        "hbm_utilization": msps * 1e6 * bytes_per_sample / PEAK_HBM_BPS,
        "peak_assumption": (
            f"{card or 'no card'}: NVIDIA H100 SXM data sheet peaks, "
            "67 TFLOP/s float32 (no tensor cores), 3.35 TB/s HBM3"),
    }


def _synth_iq8_chunks(base, starts, bins, k, m, total_chunks, chunk,
                      hmat, amp=0.5):
    """int8 (chunk, 2) wideband chunks through the synthesis bank on the
    host, bench.py's bytes: the same NumPy operations in the same order
    (``synthesize_bank_host`` is the reference's synthesis bank), with the
    filter state carried across chunk seams: each chunk re-synthesizes the
    previous one's last 2T blocks (pad, even, so block parity holds) and
    drops the warm-up, which equals one-shot synthesis. Independent chunks
    would lose the overlap-add tail at every seam, an artifact a real
    capture never has. hmat may be a tensor on any device."""
    xs = _synthesize_host(
        lambda j: base[starts[:, None] + j * k + np.arange(k)[None, :]],
        bins, k, m, total_chunks, chunk, hmat, amp)
    scale = 118.0 / _peak(xs)
    return [np.clip(np.stack([x.real, x.imag], -1) * scale, -127, 127
                    ).astype(np.int8) for x in xs]


def _synthesize_host(rows_of, bins, k, m, total_chunks, chunk, hmat,
                     amp=0.5) -> list:
    """complex64 wideband chunks of `chunk` samples through the synthesis
    bank on the host: chunk j carries rows_of(j), (len(bins), k)
    complex64, times amp on the bins; the filter state is carried across
    chunk seams as ``_synth_iq8_chunks`` says. rows_of is called once a
    chunk, in order."""
    from sdrtrunk_tpu_torch.dsp.synthesizer import synthesize_bank_host

    if hasattr(hmat, "cpu"):
        hmat = hmat.cpu().numpy()
    hmat = np.asarray(hmat)
    pad = 2 * hmat.shape[0]
    half = m // 2
    tail = np.zeros((pad, m), np.complex64)
    us = []
    for j in range(total_chunks):
        u = np.zeros((pad + k, m), np.complex64)
        u[:pad] = tail
        u[pad:, bins] = rows_of(j).T * amp
        tail = u[-pad:].copy()
        us.append(u)
    # the chunks are independent once their inputs are: NumPy releases
    # the GIL in the FFT and the array arithmetic
    with ThreadPoolExecutor(min(4, len(us), os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda u: synthesize_bank_host(u, hmat)[
            pad * half: pad * half + chunk], us))


def _peak(xs) -> float:
    """The largest |I| or |Q| over complex chunks xs."""
    return max(max(np.abs(x.real).max(), np.abs(x.imag).max()) for x in xs)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------- core bench

def bench_receiver(decoder: str, m: int, chunk_blocks: int, iters: int,
                   pull_key: str, profile_dir: str | None = None):
    """Build a WidebandReceiver and measure steady-state MS/s. compile_s is
    the first call's seconds, a kernel's first build included."""
    import torch

    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.receiver import WidebandReceiver

    dev = resolve_device(None)
    fs = m * 12500.0
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)]
    rx = WidebandReceiver(fs, offsets, decoder=decoder, device=dev)
    step, state = rx.build(), rx.init_state()

    n = m * chunk_blocks
    rng = np.random.default_rng(0)
    x = torch.as_tensor(0.1 * rng.standard_normal((n, 2)).astype(np.float32),
                        device=dev)

    t0 = time.perf_counter()
    outputs, state = step(x, state)
    probe = outputs[pull_key][:2, :8].cpu()
    compile_s = time.perf_counter() - t0
    if not torch.isfinite(probe.float()).all():
        raise RuntimeError(f"{decoder} produced non-finite output")

    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    with prof:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            outputs, state = step(x, state)    # state-chained
        _sync(dev)
        _ = outputs[pull_key][:2, :8].cpu()
        elapsed = time.perf_counter() - t0

    msps = n * iters / elapsed / 1e6
    result = {
        "msps": msps,
        "realtime_factor": msps * 1e6 / fs,
        "channels": rx.num_channels,
        "wideband_rate_msps": fs / 1e6,
        "chunk_samples": n,
        "iters": iters,
        "compile_s": compile_s,
    }
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              f"{decoder}.json"))
        result["profile_device_events"] = sum(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return result, rx


# ------------------------------------------------------------- overhead

def measure_dispatch_overhead() -> dict:
    """Steady-state wall time of ONE trivial elementwise op on the card
    (a multiply) at 21 MB and at 168 MB, synchronised: the small size is
    about the launch cost, the large one the memory rate."""
    import torch

    from sdrtrunk_tpu_torch import resolve_device

    dev = resolve_device(None)
    rng = np.random.default_rng(0)
    out = {}
    for mb, key in ((21, "small_op_ms"), (168, "large_op_ms")):
        n = mb * 1024 * 1024 // 4
        x = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=dev)
        y = torch.mul(x, 1.0001)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            y = torch.mul(x, 1.0001)
        _sync(dev)
        _ = y[:4].cpu()
        out[key] = (time.perf_counter() - t0) / 10 * 1e3
    out["note"] = ("one torch.mul a call, synchronised; the small-op time "
                   "is about the launch cost every per-chunk figure holds")
    return out


# ------------------------------------------------------------- orchestrator

def bench_orchestrator(slots: int = 8, iters: int = 20) -> dict:
    """The live loop end to end at 8 slots (the per-slot path): the
    orchestrator's device step, the transfer of per-slot dibits and valid
    and the Python framing layer a chunk. Every slot is active with a
    P25P1 processor hunting sync in noise."""
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    m = 64
    fs = m * 12500.0
    rng = np.random.default_rng(0)
    chunk = m * 2048
    noise = (0.05 * (rng.standard_normal(chunk)
                     + 1j * rng.standard_normal(chunk))
             ).astype(np.complex64)

    def source(num):
        return noise[:num]

    orch = Orchestrator(source, fs, 460e6, [25000.0], slots=slots,
                        decoder="c4fm", chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False)
    offsets = [12_500.0 * k for k in range(-14, 15)
               if 12_500.0 * k != 25_000.0][:slots - 1]
    for off in offsets:
        orch._activate(460e6 + off, IdentifierCollection())
    assert sum(s.active for s in orch.slots) == slots

    orch.run(max_chunks=2)                     # kernel load + warmup
    t0 = time.perf_counter()
    orch.run(max_chunks=iters)                 # double-buffered live loop
    elapsed = time.perf_counter() - t0
    msps = chunk * iters / elapsed / 1e6
    return {
        "msps": msps,
        "realtime_factor": msps * 1e6 / fs,
        "slots": slots,
        "wideband_rate_msps": fs / 1e6,
        "chunk_samples": chunk,
        "iters": iters,
    }


def bench_kernel_vs_plain(c: int = 1023, t: int = 10240) -> dict:
    """Each symbol-loop kernel through ``batched`` on (c, t) blocks, over 4
    state-chained iterations, beside its plain PyTorch loop
    (``scan_packed``, a Python loop over samples) over 1 iteration on the
    same device. The plain loop is a check that the pair runs, not a
    yardstick: its rate is the host's Python speed."""
    import torch

    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator,
                                            GardnerDQPSKDemodulator)
    from sdrtrunk_tpu_torch.tree import tree_map

    dev = resolve_device(None)
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((c, t, 2)).astype(np.float32) * 0.5
    x = torch.view_as_complex(torch.as_tensor(x2, device=dev))
    out = {}
    for name, cls in (("decision_directed", DQPSKDemodulator),
                      ("gardner", GardnerDQPSKDemodulator)):
        demod = cls(sample_rate=25000.0, device=dev)
        calls = {"kernel": lambda st: demod.batched(x, st)[::2],
                 "plain": lambda st: demod.scan_packed(x, st)}
        for impl, iters in (("kernel", 4), ("plain", 1)):
            run = calls[impl]
            st = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                          demod.init_state())
            if impl == "kernel":
                d, st = run(st)                # kernel load
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                d, st = run(st)
            _sync(dev)
            _ = d[:2, :8].cpu()
            dt = time.perf_counter() - t0
            out[f"{name}_{impl}_mcsps"] = c * t * iters / dt / 1e6
    for name in ("decision_directed", "gardner"):
        out[f"{name}_speedup"] = (out[f"{name}_kernel_mcsps"]
                                  / out[f"{name}_plain_mcsps"])
    out["unit"] = f"Mchan-samples/s, ({c}, {t}) blocks"
    return out


def bench_digital_protocols(m: int = 1024, blocks: int = 5120,
                            iters: int = 12) -> dict:
    """Throughput of every digital protocol family through the full
    WidebandReceiver: DMR on the DQPSK kernel at gain 0.4, LSM and P25P2
    on the Gardner kernel."""
    out = {}
    for decoder in ("dmr", "lsm", "p25p2"):
        try:
            r, _ = bench_receiver(decoder, m, blocks, iters, "power_db")
            out[decoder] = r
        except Exception as e:                  # noqa: BLE001 — bench aux
            out[decoder] = {"error": f"{type(e).__name__}: {e}"[:400]}
    return out


def _ingest_label(ingest: str) -> str:
    return ("packed int4 IQ (12.8 MB/s at 12.8 MHz)" if ingest == "int4"
            else "int8 IQ pairs (25.6 MB/s at 12.8 MHz)")


def _chunk_source(iq8_chunks, chunk: int):
    pos = 0

    def source(num):
        nonlocal pos
        j = pos // chunk
        pos += num
        return iq8_chunks[j] if j < len(iq8_chunks) else None

    return source


@dataclass
class BankScene:
    """A bank leg's scene: the int8 chunks it feeds and the Orchestrator
    that runs them, slots activated (and for P25 Phase 2 the scramble
    parameters set); ``warmup`` untimed chunks then ``timed_chunks``;
    ``segments`` the (slot, AudioSegment) pairs the bank (or each slot's
    processor) drains, in the order ``orch.audio_segments`` takes them
    (``_segment_slots``); ``steps`` what ``run_bank`` recorded of the
    recipe's steps (``_run_steps``)."""
    kind: str                   # "c4fm", "dmr", "p25p2", "nbfm", "lsm",
                                # "am", "ltr" or "mpt1327"
    orch: object
    chunks: list
    warmup: int
    timed_chunks: int
    segments: list
    ingest: str = "auto"
    recipe: dict | None = None  # a cell's (``cell_bytes``)
    steps: dict = field(default_factory=dict)


def _segment_slots(orch) -> list:
    """Record each AudioSegment drained beside its slot, in the order
    ``orch.audio_segments`` takes them, and return the list it fills. The
    bank tier: wraps ``orch.bank_proc.drain_audio`` on this instance. The
    per-slot tier and ``banks=``: wraps each slot processor's
    ``drain_audio`` on the instance, also of a processor a grant makes
    later (``orch.traffic.on_activate`` wrapped). Both packages have
    these; with ``host_process`` the worker drains and nothing is
    recorded."""
    pairs = []
    proc = orch.bank_proc
    if proc is not None:
        drain = proc.drain_audio

        def drain_audio(slot):
            done = drain(slot)
            pairs.extend((slot, seg) for seg in done)
            return done
        proc.drain_audio = drain_audio
        return pairs
    if orch.bank_mode:          # host_process=True: the worker drains
        return pairs

    def wrap_processors():
        for s in orch.slots:
            p = s.processor
            if p is None or "drain_audio" in vars(p):
                continue

            def drain_audio(drain=p.drain_audio, index=s.index):
                done = drain()
                pairs.extend((index, seg) for seg in done)
                return done
            p.drain_audio = drain_audio
    wrap_processors()
    activate = orch.traffic.on_activate

    def on_activate(*args, **kw):
        activate(*args, **kw)
        wrap_processors()
    orch.traffic.on_activate = on_activate
    return pairs


def scene_orchestrator_bank(slots: int = 1023, timed_chunks: int = 4,
                            chunk_blocks: int = 5120,
                            ingest: str = "auto") -> BankScene:
    """The scene of the 1000-channel live target end to end: 12.8 MHz
    wideband, every usable bin carrying a P25P1 voice call cycle, int8 IQ
    (or packed int4) uploaded to the card, the orchestrator's bank-mode
    device step (channelize -> 1023-wide DQPSK kernel -> compaction + sync
    correlation -> bit-packed transfer) and the full host layer (bank
    framer, message decode, decoder states, MBE audio segments) for every
    chunk. The chunks are bench.py's bytes (``_synth_iq8_chunks``)."""
    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.protocol.p25p1.duid import DUID
    from sdrtrunk_tpu_torch.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_tpu_torch.protocol.p25p1.hdu import tdulc_encode
    from sdrtrunk_tpu_torch.protocol.p25p1.lc import lc_build_group_voice
    from sdrtrunk_tpu_torch.protocol.p25p1.ldu import ldu1_encode, ldu2_encode
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    dev = resolve_device(None)
    m = 1024
    fs = m * 12500.0
    chunk = m * chunk_blocks            # 5120 -> 5.24 MS = 0.41 s/chunk
    k = 2 * chunk // m                  # per-channel samples per chunk
    # 3 warmup chunks: kernel load + the mass-acquisition transient of
    # 1023 fresh PLLs
    warmup = 3
    total_chunks = warmup + timed_chunks

    # a complete call cycle per slot: two LDU pairs then a terminator, so
    # calls end and voice -> AudioSegment egress runs under the bench
    rng = np.random.default_rng(0)
    asm = P25P1FrameAssembler()
    lc = lc_build_group_voice(0x457, 0xABCDE)
    p1 = ldu1_encode(lc, rng.integers(0, 2, (9, 144)).astype(np.uint8))
    p2 = ldu2_encode(rng.integers(0, 2, 72).astype(np.uint8), 0x80, 1,
                     rng.integers(0, 2, (9, 144)).astype(np.uint8))
    sf = np.concatenate([asm.assemble(DUID.LDU1, p1),
                         asm.assemble(DUID.LDU2, p2),
                         asm.assemble(DUID.LDU1, p1),
                         asm.assemble(DUID.LDU2, p2),
                         asm.assemble(DUID.TDULC, tdulc_encode(lc))])
    ch = Channelizer.design(fs, 12500.0, device=dev)
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)][:slots]
    bins = np.array([ch.channel_for_frequency(o) for o in offsets])
    starts = rng.integers(0, len(sf) * 5, slots)

    # modulate once; per-slot start offsets de-correlate sync lags; no
    # wrap-around
    need = int(starts.max()) + (total_chunks + 1) * k + len(sf)
    dibits = np.tile(sf, need // (len(sf) * 5) + 2)
    base = c4fm_modulate(dibits, sample_rate=25000.0).astype(np.complex64)
    assert len(base) >= need

    iq8_chunks = _synth_iq8_chunks(base, starts, bins, k, m,
                                   total_chunks, chunk, ch.hmat)

    orch = Orchestrator(_chunk_source(iq8_chunks, chunk), fs, 460e6,
                        [offsets[0]], slots=slots, decoder="c4fm",
                        chunk_samples=chunk, idle_teardown_seconds=1e9,
                        ppm_correction=False, ingest_format=ingest,
                        device=dev)
    for off in offsets[1:]:
        orch._activate(460e6 + off, IdentifierCollection())
    assert sum(s.active for s in orch.slots) == slots
    return BankScene("c4fm", orch, iq8_chunks, warmup, timed_chunks,
                     _segment_slots(orch), ingest)


def scene_orchestrator_bank_dmr(slots: int = 1023, timed_chunks: int = 4,
                                chunk_blocks: int = 5120,
                                host_process: bool = False,
                                ingest: str = "auto") -> BankScene:
    """The scene of the DMR leg of the 1000-channel live target: 12.8 MHz
    int8 IQ (bench.py's bytes), every usable bin carrying a continuous DMR
    call cycle (voice header -> 4 voice superframes with embedded LC ->
    terminator), decoded by the orchestrator's DMR bank tier (the DQPSK
    kernel at gain 0.4, device 7-pattern sync correlation, the host
    DMRBankFramer)."""
    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.protocol.bits import bits_to_dibits
    from sdrtrunk_tpu_torch.protocol.dmr.framer import (DataType,
                                                        DMRBurstAssembler,
                                                        VOICE_FRAME_ORDER)
    from sdrtrunk_tpu_torch.protocol.dmr.lc import (MASK_TERMINATOR,
                                                    MASK_VOICE_HEADER,
                                                    embedded_lc_encode,
                                                    full_lc_encode,
                                                    lc_build_group_voice)
    from sdrtrunk_tpu_torch.protocol.dmr.sync import DMRSyncPattern
    from sdrtrunk_tpu_torch.protocol.edac.bptc import bptc_196_96_encode
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    dev = resolve_device(None)
    m = 1024
    fs = m * 12500.0
    chunk = m * chunk_blocks
    k = 2 * chunk // m
    warmup = 3
    total_chunks = warmup + timed_chunks

    rng = np.random.default_rng(0)
    asm = DMRBurstAssembler(color_code=1)
    lc = lc_build_group_voice(group=0x222, source=0x333)
    vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    tlc = bptc_196_96_encode(full_lc_encode(lc, MASK_TERMINATOR))
    frags = embedded_lc_encode(lc)
    cycle = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                            DataType.VOICE_HEADER, vh)]
    for _ in range(4):                      # 4 voice superframes
        ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
        cycle.append(asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE,
                                     ambe))
        for i, vf in enumerate(VOICE_FRAME_ORDER):
            cycle.append(asm.voice_burst(
                vf, ambe, emb_lcss=[1, 3, 3, 2, 0][i],
                lc_fragment=frags[i] if i < 4 else None))
    cycle.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                DataType.TLC, tlc))
    sf = bits_to_dibits(np.concatenate(cycle))

    ch = Channelizer.design(fs, 12500.0, device=dev)
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)][:slots]
    bins = np.array([ch.channel_for_frequency(o) for o in offsets])
    starts = rng.integers(0, len(sf) * 3, slots)
    need = int(starts.max()) + (total_chunks + 1) * k + len(sf)
    dibits = np.tile(sf, need // (len(sf) * 5) + 2)
    base = c4fm_modulate(dibits, sample_rate=25000.0).astype(np.complex64)
    assert len(base) >= need

    iq8_chunks = _synth_iq8_chunks(base, starts, bins, k, m,
                                   total_chunks, chunk, ch.hmat)

    orch = Orchestrator(_chunk_source(iq8_chunks, chunk), fs, 460e6,
                        [offsets[0]], slots=slots, decoder="dmr",
                        chunk_samples=chunk, idle_teardown_seconds=1e9,
                        ppm_correction=False, host_process=host_process,
                        ingest_format=ingest, device=dev)
    for off in offsets[1:]:
        orch._activate(460e6 + off, IdentifierCollection())
    assert sum(s.active for s in orch.slots) == slots
    assert orch.bank_mode
    return BankScene("dmr", orch, iq8_chunks, warmup, timed_chunks,
                     _segment_slots(orch), ingest)


def scene_orchestrator_bank_p25p2(slots: int = 1023,
                                  timed_chunks: int = 4,
                                  chunk_blocks: int = 5120,
                                  host_process: bool = False,
                                  ingest: str = "auto") -> BankScene:
    """The scene of the P25 Phase 2 leg of the 1000-channel live target:
    12.8 MHz int8 IQ (bench.py's bytes), every usable bin carrying a
    scrambled HDQPSK voice stream (SACCH PTT + VOICE_4 fragments at 6000
    baud), decoded through the P25P2 bank tier (the Gardner kernel at W =
    16, device 20-dibit sync correlation, the host P25P2BankFramer and
    per-slot MAC states)."""
    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.protocol.bits import from_int
    from sdrtrunk_tpu_torch.protocol.p25p2 import P25P2FragmentAssembler
    from sdrtrunk_tpu_torch.protocol.p25p2.timeslot import (MacPduType,
                                                            sacch_encode,
                                                            voice4_encode)
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.signal.generators import lsm_modulate

    dev = resolve_device(None)
    wacn, system, nac = 0xA4BC3, 0x123, 0x29A
    m = 1024
    fs = m * 12500.0
    chunk = m * chunk_blocks
    k = 2 * chunk // m
    warmup = 3
    total_chunks = warmup + timed_chunks

    rng = np.random.default_rng(0)
    asm = P25P2FragmentAssembler(wacn=wacn, system=system, nac=nac)
    ptt = np.zeros(180, np.uint8)
    ptt[0:3] = from_int(MacPduType.PTT.value, 3)
    ptt[80:88] = from_int(0x80, 8)
    ptt[104:128] = from_int(0xABCDE, 24)
    ptt[128:144] = from_int(0x457, 16)
    endptt = np.zeros(180, np.uint8)
    endptt[0:3] = from_int(MacPduType.END_PTT.value, 3)
    endptt[104:128] = from_int(0xABCDE, 24)
    endptt[128:144] = from_int(0x457, 16)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    frags = [asm.assemble(i, [sacch_encode(ptt, scrambled=True),
                              voice4_encode(frames),
                              sacch_encode(ptt, scrambled=True),
                              voice4_encode(frames)])
             for i in range(3)]
    # calls end once per cycle so voice -> AudioSegment egress runs
    frags.append(asm.assemble(0, [sacch_encode(endptt, scrambled=True),
                                  voice4_encode(frames),
                                  sacch_encode(endptt, scrambled=True),
                                  voice4_encode(frames)]))
    sf = P25P2FragmentAssembler.to_dibits(frags)   # one call cycle

    ch = Channelizer.design(fs, 12500.0, device=dev)
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)][:slots]
    bins = np.array([ch.channel_for_frequency(o) for o in offsets])
    starts = rng.integers(0, len(sf) * 3, slots)
    need = int(starts.max()) + (total_chunks + 1) * k + len(sf)
    dibits = np.tile(sf, need // (len(sf) * 4) + 2)
    base = lsm_modulate(dibits, sample_rate=25000.0,
                        symbol_rate=6000.0).astype(np.complex64)
    assert len(base) >= need

    iq8_chunks = _synth_iq8_chunks(base, starts, bins, k, m,
                                   total_chunks, chunk, ch.hmat)

    orch = Orchestrator(_chunk_source(iq8_chunks, chunk), fs, 460e6,
                        [offsets[0]], slots=slots, decoder="p25p2",
                        chunk_samples=chunk, idle_teardown_seconds=1e9,
                        ppm_correction=False, host_process=host_process,
                        ingest_format=ingest, device=dev)
    for off in offsets[1:]:
        orch._activate(460e6 + off, IdentifierCollection())
    assert orch.bank_mode
    # traffic channels carry the system's scramble parameters (a control
    # channel's preload in production; set directly for the bench)
    if host_process:
        for s in range(slots):
            orch.bank_host.reset_slot(
                s, extra={"scramble_key": (wacn, system, nac)},
                frequency=460e6 + offsets[min(s, len(offsets) - 1)])
    else:
        for s in range(slots):
            orch.bank_proc.framer.set_scramble_parameters(s, wacn,
                                                          system, nac)
            if orch.bank_proc.states[s] is not None:
                orch.bank_proc.states[s].scramble_key = (wacn, system,
                                                         nac)
    return BankScene("p25p2", orch, iq8_chunks, warmup, timed_chunks,
                     _segment_slots(orch), ingest)


def scene_orchestrator_bank_nbfm(slots: int = 1023, timed_chunks: int = 6
                                 ) -> BankScene:
    """The scene of the analog leg of the 1000-channel live target: 12.8
    MHz int8 IQ (bench.py's bytes), every usable bin carrying NBFM voice,
    the orchestrator's analog bank step (channelize -> 1023-wide FM
    demod/squelch/resample -> mu-law PCM + packed gate transfer) and
    per-slot AudioSegment assembly on the host."""
    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.signal.generators import nbfm_modulate

    dev = resolve_device(None)
    m = 1024
    fs = m * 12500.0
    chunk = m * 6400                    # K = 12800 per channel (mult 25)
    k = 2 * chunk // m
    warmup = 2
    total_chunks = warmup + timed_chunks

    rng = np.random.default_rng(0)
    need_audio = int((total_chunks * k + m) / 25000.0 * 8000.0) + 8000
    audio = 0.7 * np.sin(2 * np.pi * 700.0 *
                         np.arange(need_audio) / 8000.0)
    base = nbfm_modulate(audio, 8000.0, 25000.0).astype(np.complex64)

    ch = Channelizer.design(fs, 12500.0, device=dev)
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)][:slots]
    bins = np.array([ch.channel_for_frequency(o) for o in offsets])
    starts = rng.integers(0, 25000, slots)

    iq8_chunks = _synth_iq8_chunks(base, starts, bins, k, m,
                                   total_chunks, chunk, ch.hmat)

    orch = Orchestrator(_chunk_source(iq8_chunks, chunk), fs, 460e6,
                        [offsets[0]], slots=slots, decoder="nbfm",
                        chunk_samples=chunk, idle_teardown_seconds=1e9,
                        ppm_correction=False, bank_mode=True, device=dev)
    for off in offsets[1:]:
        orch._activate(460e6 + off, IdentifierCollection())
    return BankScene("nbfm", orch, iq8_chunks, warmup, timed_chunks,
                     _segment_slots(orch), "auto")


# ------------------------------------------------------------- cells

# chip_smoke.py's live cells beside the bench banks, rebuilt on the host
# (``cell_bytes``): each mirrors its live phase's geometry and streams in
# NumPy, so that both packages decode the same bytes on every machine
CENTER_HZ = 460e6
GROUP, SOURCE = 0x457, 0xABCDE
VOICE_TONE_HZ = 800.0


def p25_streams(total_dibits: int, base_hz: float, traffic_index: int,
                band_id: int = 1, spacing_hz: float = 12500.0,
                traffic_start_s: float = 1.3, group: int = GROUP,
                source: int = SOURCE, grant_from_s: float = 0.0):
    """(control, traffic, voice superframe) P25P1 dibit streams; the
    control channel grants channel traffic_index of the band at base_hz,
    which its IDEN_UP announces as band band_id of spacing_hz channels,
    sending an RFSS status in each grant's place that starts before
    grant_from_s; the call on the traffic channel starts at
    traffic_start_s, after the grant's latency."""
    from sdrtrunk_tpu_torch.protocol.bits import from_int
    from sdrtrunk_tpu_torch.protocol.p25p1.duid import DUID
    from sdrtrunk_tpu_torch.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_tpu_torch.protocol.p25p1.hdu import hdu_encode, tdulc_encode
    from sdrtrunk_tpu_torch.protocol.p25p1.lc import lc_build_group_voice
    from sdrtrunk_tpu_torch.protocol.p25p1.ldu import ldu1_encode, ldu2_encode
    from sdrtrunk_tpu_torch.protocol.p25p1.tsbk import tsbk_encode

    rng = np.random.default_rng(11)
    asm = P25P1FrameAssembler(nac=0x293)
    iden = np.zeros(64, np.uint8)              # IDEN_UP, tsbk.py:348-355
    iden[0:4] = from_int(band_id, 4)
    units = int(spacing_hz / 125.0)            # 100: 12.5 kHz
    iden[4:13] = from_int(units, 9)            # bandwidth
    iden[22:32] = from_int(units, 10)          # spacing
    iden[32:64] = from_int(int(base_hz / 5), 32)
    grant = np.zeros(64, np.uint8)             # GROUP_VOICE_CHANNEL_GRANT
    grant[8:12] = from_int(band_id, 4)
    grant[12:24] = from_int(traffic_index, 12)
    grant[24:40] = from_int(group, 16)
    grant[40:64] = from_int(source, 24)
    t_iden = asm.assemble(DUID.TSBK, tsbk_encode(0x3D, iden))
    t_grant = asm.assemble(DUID.TSBK, tsbk_encode(0x00, grant))
    t_rfss = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    parts = [rng.integers(0, 4, 120).astype(np.uint8), t_iden, t_iden,
             t_grant, t_grant]
    # IDEN_UP is rebroadcast through the stream, as a control channel
    # does, so a receiver that missed the first one still maps the grant
    while sum(len(p) for p in parts) < total_dibits - 2 * len(t_grant):
        parts += [t_rfss, t_iden, t_grant]
    starts = np.cumsum([0] + [len(p) for p in parts[:-1]])
    control = np.concatenate([
        t_rfss if p is t_grant and at < grant_from_s * 4800 else p
        for p, at in zip(parts, starts)])

    lc = lc_build_group_voice(group=group, source=source)
    call = [asm.assemble(DUID.HDU, hdu_encode(np.zeros(72, np.uint8), 0,
                                              0x80, 0, talkgroup=group))]
    call += [asm.assemble(DUID.LDU1, ldu1_encode(
        lc, rng.integers(0, 2, (9, 144)).astype(np.uint8))) for _ in range(4)]
    call.append(asm.assemble(DUID.TDULC, tdulc_encode(lc)))
    start = int(traffic_start_s * 4800)
    traffic = np.concatenate(
        [rng.integers(0, 4, start).astype(np.uint8)] + call)

    vasm = P25P1FrameAssembler()
    p1 = ldu1_encode(lc, rng.integers(0, 2, (9, 144)).astype(np.uint8))
    p2 = ldu2_encode(rng.integers(0, 2, 72).astype(np.uint8), 0x80, 1,
                     rng.integers(0, 2, (9, 144)).astype(np.uint8))
    superframe = np.concatenate([vasm.assemble(DUID.LDU1, p1),
                                 vasm.assemble(DUID.LDU2, p2),
                                 vasm.assemble(DUID.LDU1, p1),
                                 vasm.assemble(DUID.LDU2, p2),
                                 vasm.assemble(DUID.TDULC, tdulc_encode(lc))])

    def pad(d):
        return np.concatenate(
            [d, rng.integers(0, 4, max(total_dibits - len(d), 0))
             .astype(np.uint8)])[:total_dibits]
    return pad(control), pad(traffic), superframe


def lsm_tsbks():
    """A P25P1 control stream of TSBKs (tests/test_orchestrator_bank.py's
    LSM scene)."""
    from sdrtrunk_tpu_torch.protocol.p25p1.duid import DUID
    from sdrtrunk_tpu_torch.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_tpu_torch.protocol.p25p1.tsbk import tsbk_encode

    rng = np.random.default_rng(5)
    asm = P25P1FrameAssembler(nac=0x293)
    tsbk = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    return np.concatenate([rng.integers(0, 4, 150).astype(np.uint8)]
                          + [tsbk] * 6)


def mpt_control(n: int, rate: float, rng, channel: int):
    """n samples at rate of an NBFM control channel of MPT1327 AFSK
    codewords: ALH, then GTC for traffic channel `channel`, repeated, each
    after 24 random bits and the control sync (1 -> 1200 Hz, 0 -> 1800 Hz
    at 8 kHz, phase-continuous, at 0.35)."""
    from sdrtrunk_tpu_torch.protocol.bits import from_int
    from sdrtrunk_tpu_torch.protocol.mpt1327 import (SYNC_CONTROL,
                                                     mpt_encode_codeword)
    from sdrtrunk_tpu_torch.signal.generators import nbfm_modulate

    def address_word(prefix, ident1):
        d = np.zeros(48, np.uint8)
        d[0] = 1
        d[1:8] = from_int(prefix, 7)
        d[8:21] = from_int(ident1, 13)
        return d
    alh = address_word(3, 88)
    alh[21:30] = from_int(256, 9)
    alh[44:48] = from_int(5, 4)
    gtc = address_word(10, 1000)
    gtc[21:31] = from_int(channel, 10)
    gtc[35:48] = from_int(2000, 13)
    frame = np.concatenate([
        part for word in (alh, gtc) for part in (
            rng.integers(0, 2, 24).astype(np.uint8), SYNC_CONTROL,
            mpt_encode_codeword(word))])
    need = int(n / rate * 8000.0) + 100
    bits = np.tile(frame, int(need * 1200 / 8000) // len(frame) + 2)
    sym = np.minimum((np.arange(need) * 1200 / 8000).astype(np.int64),
                     len(bits) - 1)
    tone = 2 * np.pi * np.cumsum(np.where(bits[sym] == 1, 1200.0, 1800.0))
    return nbfm_modulate(0.35 * np.sin(tone / 8000.0), 8000.0, rate)[:n]


P25P2_KEY = (0xA4BC3, 0x123, 0x29A)            # WACN, system, NAC
TRAFFIC_INDEX = 600              # the channel phase 5's control grants
SLOT_COUNT = 31                  # the most slots bank_mode=None runs per slot
SLOTS_TRAFFIC_INDEX = 300        # the channel the per-slot control grants
MULTIBANK = [("c4fm", 11), ("dmr", 10), ("ltr", 10)]


def p25p2_cycle(key=P25P2_KEY, group: int = GROUP, source: int = SOURCE):
    """One call cycle of P25P2 dibits: three fragments of scrambled PTT
    (SACCH, TDMA channel 0) + VOICE_4 (channel 1), then a fragment of
    scrambled END_PTT on both TDMA channels, so that each cycle's voice
    ends as an AudioSegment."""
    from sdrtrunk_tpu_torch.protocol.bits import from_int
    from sdrtrunk_tpu_torch.protocol.p25p2 import P25P2FragmentAssembler
    from sdrtrunk_tpu_torch.protocol.p25p2.timeslot import (MacPduType,
                                                            sacch_encode,
                                                            voice4_encode)

    rng = np.random.default_rng(0)
    asm = P25P2FragmentAssembler(*key)
    ptt = np.zeros(180, np.uint8)
    ptt[0:3] = from_int(MacPduType.PTT.value, 3)
    ptt[80:88] = from_int(0x80, 8)
    ptt[104:128] = from_int(source, 24)
    ptt[128:144] = from_int(group, 16)
    endptt = np.zeros(180, np.uint8)
    endptt[0:3] = from_int(MacPduType.END_PTT.value, 3)
    endptt[104:128] = from_int(source, 24)
    endptt[128:144] = from_int(group, 16)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    frags = [asm.assemble(i, [sacch_encode(ptt, scrambled=True),
                              voice4_encode(frames),
                              sacch_encode(ptt, scrambled=True),
                              voice4_encode(frames)]) for i in range(3)]
    frags.append(asm.assemble(0, [sacch_encode(endptt, scrambled=True)] * 4))
    return P25P2FragmentAssembler.to_dibits(frags)


def p25p2_control(total_dibits: int, base_hz: float,
                  traffic_index: int = SLOTS_TRAFFIC_INDEX, key=P25P2_KEY,
                  group: int = GROUP, source: int = SOURCE):
    """A P25P2 control channel (tests/test_orchestrator_protocols.py's):
    an unscrambled network status MAC that teaches the scramble key and an
    IDEN_UP of the band at base_hz, then MAC grants of channel
    traffic_index to group, the network status and IDEN_UP again every
    fourth fragment."""
    from sdrtrunk_tpu_torch.protocol.bits import from_int
    from sdrtrunk_tpu_torch.protocol.p25p2 import P25P2FragmentAssembler
    from sdrtrunk_tpu_torch.protocol.p25p2.mac import (build_mac_pdu,
                                                       mac_structure_encode)
    from sdrtrunk_tpu_torch.protocol.p25p2.timeslot import (MacPduType,
                                                            facch_encode)

    wacn, system, nac = key
    net = mac_structure_encode(123, {
        "wacn": wacn, "system_id": system, "color_code": nac,
        "frequency_band": 1, "channel_number": 2})
    iden = np.zeros(72, np.uint8)
    iden[0:8] = from_int(125, 8)
    iden[8:12] = from_int(1, 4)                 # band id 1
    iden[12:21] = from_int(100, 9)              # 12.5 kHz bandwidth
    iden[30:40] = from_int(100, 10)             # 12.5 kHz spacing
    iden[40:72] = from_int(int(base_hz / 5), 32)
    grant = mac_structure_encode(64, {
        "service_options": 0, "frequency_band": 1,
        "channel_number": traffic_index, "group_address": group,
        "source_address": source})

    def facch(pdu_type, structures):
        return facch_encode(build_mac_pdu(pdu_type, structures, 156),
                            scrambled=False)
    f_net, f_iden = (facch(MacPduType.ACTIVE, [net]),
                     facch(MacPduType.ACTIVE, [iden]))
    f_grant, idle = (facch(MacPduType.ACTIVE, [grant]),
                     facch(MacPduType.IDLE, []))
    asm = P25P2FragmentAssembler(wacn=wacn, system=system, nac=nac)
    frags = [asm.assemble(0, [f_net, f_iden, f_net, f_iden])]
    per = len(P25P2FragmentAssembler.to_dibits(frags[:1]))
    i = 1
    while len(frags) * per < total_dibits:
        body = ([f_net, f_iden, f_net, f_iden] if i % 4 == 0
                else [f_grant, idle, f_grant, idle])
        frags.append(asm.assemble(i % 3, body))
        i += 1
    rng = np.random.default_rng(41)
    return np.concatenate([rng.integers(0, 4, 200).astype(np.uint8),
                           P25P2FragmentAssembler.to_dibits(frags)])


def dmr_streams(total_dibits: int, traffic_index: int = TRAFFIC_INDEX,
                group: int = GROUP, source: int = SOURCE):
    """(control, traffic, call cycle) DMR dibit streams. The control
    channel (tests/test_orchestrator_bank.py's TSCC) sends an aloha, then a
    Tier III group-voice grant (CSBK 0x31) for channel traffic_index every
    632 dibits; the traffic channel carries one call cycle after the
    grant's latency; the cycle is bench.py's: voice header, 4 voice
    superframes (burst A with sync, B-F with EMB, embedded LC on B-E),
    terminator."""
    from sdrtrunk_tpu_torch.protocol.bits import from_int
    from sdrtrunk_tpu_torch.protocol.dmr.csbk import csbk_encode
    from sdrtrunk_tpu_torch.protocol.dmr.framer import (DataType,
                                                        DMRBurstAssembler,
                                                        VOICE_FRAME_ORDER)
    from sdrtrunk_tpu_torch.protocol.dmr.lc import (MASK_TERMINATOR,
                                                    MASK_VOICE_HEADER,
                                                    embedded_lc_encode,
                                                    full_lc_encode,
                                                    lc_build_group_voice)
    from sdrtrunk_tpu_torch.protocol.dmr.sync import DMRSyncPattern
    from sdrtrunk_tpu_torch.protocol.edac.bptc import bptc_196_96_encode

    rng = np.random.default_rng(31)
    asm = DMRBurstAssembler(color_code=1)
    lc = lc_build_group_voice(group=group, source=source)
    vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    tlc = bptc_196_96_encode(full_lc_encode(lc, MASK_TERMINATOR))
    frags = embedded_lc_encode(lc)
    cycle = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                            DataType.VOICE_HEADER, vh)]
    for _ in range(4):
        ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
        cycle.append(asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE,
                                     ambe))
        for i, vf in enumerate(VOICE_FRAME_ORDER):
            cycle.append(asm.voice_burst(
                vf, ambe, emb_lcss=[1, 3, 3, 2, 0][i],
                lc_fragment=frags[i] if i < 4 else None))
    cycle.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                DataType.TLC, tlc))
    call = DMRBurstAssembler.to_dibits(cycle)

    grant_bits = np.zeros(64, np.uint8)
    grant_bits[0:12] = from_int(traffic_index, 12)     # Tier III channel
    grant_bits[16:40] = from_int(group, 24)
    grant_bits[40:64] = from_int(source, 24)
    grant = DMRBurstAssembler.to_dibits([asm.data_burst(
        DMRSyncPattern.BASE_STATION_DATA, DataType.CSBK,
        csbk_encode(0x31, grant_bits))])
    aloha = DMRBurstAssembler.to_dibits([asm.data_burst(
        DMRSyncPattern.BASE_STATION_DATA, DataType.CSBK,
        csbk_encode(0x19, np.zeros(64, np.uint8)))])
    parts = [rng.integers(0, 4, 140).astype(np.uint8), aloha]
    while sum(len(p) for p in parts) < total_dibits:
        parts += [grant, rng.integers(0, 4, 500).astype(np.uint8)]
    control = np.concatenate(parts)[:total_dibits]
    start = int(1.3 * 4800)                    # after the grant's latency
    traffic = np.concatenate([rng.integers(0, 4, start).astype(np.uint8),
                              call])
    traffic = np.concatenate([traffic, rng.integers(
        0, 4, max(total_dibits - len(traffic), 0)).astype(np.uint8)])
    return control, traffic[:total_dibits], call


def dibit_rows(rows, modulate, n: int) -> np.ndarray:
    """(len(rows), n) complex64: each dibit stream of rows modulated and
    cut to n samples."""
    return np.stack([modulate(d)[:n] for d in rows]).astype(np.complex64)


def voice(slots: int, n: int, rate: float, rng, amplitude: float):
    """(slots, n) float64: the voice tone at rate, at a phase drawn from
    rng for each slot."""
    phase = rng.uniform(0, 2 * np.pi, slots)
    return amplitude * _tone(0, n, rate, VOICE_TONE_HZ, phase)


def fm_streams(message, rate: float, deviation_hz: float = 3000.0):
    """(C, n) complex64: each row of the real message (C, n)
    frequency-modulated at rate, the phase accumulated in float64 (as
    ``_FM`` does chunk by chunk, to the same bits)."""
    return _FM(len(message), rate, deviation_hz)(np.asarray(message,
                                                            np.float64))


def _grid(slots: int, full: int, traffic: int | None = None) -> np.ndarray:
    """The grid channels a cell of `slots` slots carries: the first
    `slots` of its `full`, the granted traffic channel kept (in place of
    the last) where it lies beyond them. Per-slot draws are made for the
    full grid, so a channel's stream is the full scene's at any width."""
    if not 2 <= slots <= full:
        raise ValueError(f"slots must be 2 to {full}, not {slots}")
    if traffic is None or traffic < slots:
        return np.arange(slots)
    return np.append(np.arange(slots - 1), traffic)


def _position(grid, channel: int) -> int:
    """Where grid channel `channel` sits in the grid."""
    return int(np.flatnonzero(grid == channel)[0])


def _square_fsk(bits, n0: int, n: int, sps: float, start) -> np.ndarray:
    """(C, n) float64: samples n0 to n0 + n of +/-1 by the bits (C, B) at
    sps samples a bit, read from sample offset start (C,) and wrapped
    around."""
    idx = ((np.arange(n0, n0 + n)[None, :] + start[:, None]) / sps
           ).astype(np.int64) % bits.shape[1]
    return np.take_along_axis(bits, idx, 1) * 2.0 - 1.0


def _tone(n0: int, n: int, rate: float, hz: float, phase) -> np.ndarray:
    """(C, n) float64: samples n0 to n0 + n of sin(2 pi hz t + phase) at
    rate, a phase (C,) a row."""
    t = np.arange(n0, n0 + n, dtype=np.float64)[None, :]
    return np.sin(2 * np.pi * hz / rate * t + phase[:, None])


class _FM:
    """Rows of a real message frequency-modulated chunk by chunk at the
    channel rate (deviation 3 kHz), the phase accumulated in float64
    across chunks; each call returns (C, n) complex64."""

    def __init__(self, rows: int, rate: float, deviation_hz: float = 3000.0):
        self.acc = np.zeros((rows, 1))
        self.k = 2 * np.pi * deviation_hz / rate

    def __call__(self, message) -> np.ndarray:
        s = np.cumsum(np.concatenate([self.acc, message], 1), 1)[:, 1:]
        self.acc = s[:, -1:]
        return np.exp(1j * (s * self.k)).astype(np.complex64)


def _tiled(cycle, modulate, sps: float, full: int, n: int, seed: int):
    """A dibit cycle tiled and modulated once (sps samples a symbol), and
    a random start in it for each of the `full` grid channels: (base
    complex64, starts); channel c's stream is base[starts[c]:][:n]."""
    rng = np.random.default_rng(seed)
    per = int(len(cycle) * sps)                # samples per cycle
    starts = rng.integers(0, per, full)
    base = modulate(np.tile(cycle, (int(starts.max()) + n) // per + 2))
    return base.astype(np.complex64), starts


def _cell_chunks(rows_of, fs: float, bandwidth: float, offsets, k: int,
                 total_chunks: int, chunk: int) -> list:
    """int8 (chunk, 2) chunks of the streams rows_of(j)
    (``_synthesize_host``) on the channelizer's bins at offsets, quantized
    as chip_smoke.py's ``synthesize_chunks`` quantizes: one peak over all
    chunks, scaled to 118 and rounded."""
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer

    ch = Channelizer.design(fs, bandwidth, device="cpu")
    bins = np.array([ch.channel_for_frequency(o) for o in offsets])
    xs = _synthesize_host(rows_of, bins, k, ch.channels, total_chunks,
                          chunk, ch.hmat)
    scale = 118.0 / _peak(xs)
    return [np.clip(np.round(np.stack([x.real, x.imag], -1) * scale),
                    -127, 127).astype(np.int8) for x in xs]


def _recipe(cell: str, kind: str, fs: float, offsets, slots: int,
            chunk: int, warmup: int, timed_chunks: int,
            free: int | None = None, channel_map=None, kinds=None,
            prepare=None, steps=None, **kw) -> dict:
    """What both packages' Orchestrator is built from
    (``orchestrator_from_recipe``): the control channel at offsets[0],
    every other offset activated but offsets[free] (the granted channel,
    left for the grant), bank mode, no teardown, no PPM correction; `kw`
    overrides the keyword arguments, None dropping one (``bank_mode=None``:
    the per-slot tier below 32 slots). With ``banks``, `kinds` names the
    bank of each activated offset. `prepare` and `steps` are what
    ``orchestrator_from_recipe`` and ``run_bank`` do beyond that, as data
    (``_prepare_orchestrator``, ``_run_steps``)."""
    recipe = {"cell": cell, "kind": kind, "sample_rate": fs,
              "center_hz": CENTER_HZ,
              "control_offset_hz": float(offsets[0]),
              "activate_hz": [float(o) for i, o in enumerate(offsets)
                              if i and i != free],
              "free_slots": int(free is not None),
              "channel_map": channel_map,
              "warmup": warmup, "timed_chunks": timed_chunks}
    kwargs = {"slots": slots, "decoder": kind, "chunk_samples": chunk,
              "idle_teardown_seconds": 1e9, "ppm_correction": False,
              "bank_mode": True, **kw}
    recipe["kwargs"] = {k: v for k, v in kwargs.items() if v is not None}
    for key, value in (("activate_kinds", kinds), ("prepare", prepare),
                       ("steps", steps)):
        if value is not None:
            recipe[key] = value
    return recipe


def _offsets(grid, m: int, spacing: float) -> np.ndarray:
    """The baseband offsets of grid channels of M bins at spacing."""
    return (grid - m // 2 + 1) * spacing


def _cell_ltr(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_ltr``: 1023 slots of M = 1024, each an NBFM
    carrier with the 800 Hz voice tone (0.5, a random phase) plus
    sub-audible square FSK (+/-0.35, 300 baud) of LTR CALL words for the
    slot's own talkgroup (home 1-5, group 1-253), from a random start; 2
    warm-up chunks of 1024 x 6250."""
    from sdrtrunk_tpu_torch.protocol.ltr.messages import ltr_encode_word

    m, full, warmup, rate = 1024, 1023, 2, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    grid = _grid(slots, full)
    rng = np.random.default_rng(0)
    words = np.stack([ltr_encode_word(0, s // 253 + 1, s // 253 + 1,
                                      s % 253 + 1, s // 253 + 1)
                      for s in grid])                      # (slots, 40)
    start = rng.integers(0, 40 * 84, full)[grid]
    phase = rng.uniform(0, 2 * np.pi, full)[grid]
    fm = _FM(len(grid), rate)

    def rows_of(j):
        return fm(0.35 * _square_fsk(words, j * k, k, rate / 300.0, start)
                  + 0.5 * _tone(j * k, k, rate, VOICE_TONE_HZ, phase))
    offsets = _offsets(grid, m, 12500.0)
    chunks = _cell_chunks(rows_of, fs, 12500.0, offsets, k,
                          warmup + timed_chunks, chunk)
    return chunks, _recipe("ltr", "ltr", fs, offsets, slots, chunk, warmup,
                           timed_chunks)


MPT_TRAFFIC_INDEX = 300          # the channel the MPT1327 control grants


def _cell_mpt1327(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_mpt1327``: 1023 slots of M = 1024 with a
    channel map; slot 0 an NBFM control channel of AFSK codewords (ALH,
    then GTC for channel 300, repeated), the granted channel left free
    for the grant, FM voice (800 Hz at 0.6, a random phase) on it and on
    the other 1021; 2 warm-up chunks of 1024 x 6250."""
    m, full, warmup, rate = 1024, 1023, 2, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    total = warmup + timed_chunks
    grid = _grid(slots, full, MPT_TRAFFIC_INDEX)
    rng = np.random.default_rng(13)
    control = mpt_control((total + 1) * k, rate, rng, MPT_TRAFFIC_INDEX
                          ).astype(np.complex64)
    phase = rng.uniform(0, 2 * np.pi, full)[grid]
    fm = _FM(len(grid), rate)

    def rows_of(j):
        rows = fm(0.6 * _tone(j * k, k, rate, VOICE_TONE_HZ, phase))
        rows[0] = control[j * k:(j + 1) * k]
        return rows
    offsets = _offsets(grid, m, 12500.0)
    chunks = _cell_chunks(rows_of, fs, 12500.0, offsets, k, total, chunk)
    band = {"identifier": 0, "base_frequency_hz": CENTER_HZ + offsets[0],
            "channel_spacing_hz": 12500.0}
    return chunks, _recipe("mpt1327", "mpt1327", fs, offsets, slots, chunk,
                           warmup, timed_chunks,
                           free=_position(grid, MPT_TRAFFIC_INDEX),
                           channel_map=band)


def _cell_lsm(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_lsm``: 64 slots 16 bins apart of M = 1024,
    each a P25P1 control stream of TSBKs in LSM from a random start; 1
    warm-up chunk of 1024 x 5120."""
    from sdrtrunk_tpu_torch.signal.generators import lsm_modulate

    m, full, warmup, rate = 1024, 64, 1, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    total = warmup + timed_chunks
    grid = _grid(slots, full)
    base, starts = _tiled(lsm_tsbks(),
                          lambda d: lsm_modulate(d, sample_rate=rate),
                          rate / 4800.0, full, (total + 1) * k, seed=3)
    starts = starts[grid]
    offsets = (16 * grid - m // 2 + 8) * 12500.0
    chunks = _cell_chunks(
        lambda j: base[starts[:, None] + j * k + np.arange(k)[None, :]],
        fs, 12500.0, offsets, k, total, chunk)
    return chunks, _recipe("lsm", "lsm", fs, offsets, slots, chunk, warmup,
                           timed_chunks)


def _cell_am(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_am``: 64 slots 16 bins apart of M = 1024,
    each a carrier at a random phase with a 1 kHz tone at 50% AM depth
    (the tone's phase random a slot); 1 warm-up chunk of 1024 x 6400."""
    m, full, warmup, rate = 1024, 64, 1, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    grid = _grid(slots, full)
    rng = np.random.default_rng(4)
    tone = rng.uniform(0, 2 * np.pi, full)[grid]
    carrier = np.exp(1j * rng.uniform(0, 2 * np.pi, full))[grid, None]

    def rows_of(j):
        env = 1.0 + 0.5 * _tone(j * k, k, rate, 1000.0, tone)
        return (env * carrier).astype(np.complex64)
    offsets = (16 * grid - m // 2 + 8) * 12500.0
    chunks = _cell_chunks(rows_of, fs, 12500.0, offsets, k,
                          warmup + timed_chunks, chunk)
    return chunks, _recipe("am", "am", fs, offsets, slots, chunk, warmup,
                           timed_chunks)


C4FM_25K_TRAFFIC_INDEX = 300     # the channel the 25 kHz control grants


def _cell_c4fm_25k(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_c4fm_25k``: a site on 25 kHz spacing, 511
    slots of M = 512 (a 50 kHz channel rate: DQPSK at W = 20); slot 0 a
    P25 control channel whose IDEN_UP announces 25 kHz spacing, granting
    channel 300 (left free), whose call starts at 0.6 s; P25P1 voice
    superframes on the other 509 from random starts; 2 warm-up chunks of
    512 x 5120."""
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    m, full, warmup, rate = 512, 511, 2, 50000.0
    fs, chunk = m * 25000.0, m * chunk_blocks
    k = 2 * chunk // m
    total = warmup + timed_chunks
    n = (total + 1) * k
    grid = _grid(slots, full, C4FM_25K_TRAFFIC_INDEX)
    offsets = _offsets(grid, m, 25000.0)
    control, traffic, superframe = p25_streams(
        int(n / rate * 4800) + 64, CENTER_HZ + offsets[0],
        C4FM_25K_TRAFFIC_INDEX, spacing_hz=25000.0, traffic_start_s=0.6)
    base, starts = _tiled(superframe, lambda d: c4fm_modulate(d, rate),
                          rate / 4800.0, full, n, seed=0)
    starts = starts[grid]
    free = _position(grid, C4FM_25K_TRAFFIC_INDEX)
    own = dict(zip((0, free), dibit_rows((control, traffic),
                                         lambda d: c4fm_modulate(d, rate),
                                         n)))
    chunks = _cell_chunks(_own_rows(base, starts, own, k), fs, 25000.0,
                          offsets, k, total, chunk)
    return chunks, _recipe("c4fm_25k", "c4fm", fs, offsets, slots, chunk,
                           warmup, timed_chunks, free=free,
                           channel_bandwidth=25000.0)


def _own_rows(base, starts, own: dict, k: int):
    """rows_of for ``_cell_chunks``: chunk j of each tiled stream
    (``_tiled``: base read from starts) with the rows in `own` ({row: its
    stream}) in place of theirs."""
    def rows_of(j):
        rows = base[starts[:, None] + j * k + np.arange(k)[None, :]]
        for r, stream in own.items():
            rows[r] = stream[j * k:(j + 1) * k]
        return rows
    return rows_of


def _drifted(rows_of, rf_hz, ppm: float, rate: float, k: int):
    """rows_of for ``_cell_chunks`` as a tuner reading `ppm` high captures
    it: row i, at RF frequency rf_hz[i], moved up by rf_hz[i] * ppm / 1e6,
    its phase taken at the absolute sample index (continuous across
    chunks)."""
    cycles = np.asarray(rf_hz, np.float64) * ppm * 1e-6 / rate

    def rows(j):
        n = np.arange(j * k, (j + 1) * k, dtype=np.float64)
        turn = np.exp(2j * np.pi * (np.outer(cycles, n) % 1.0))
        return (rows_of(j) * turn).astype(np.complex64)
    return rows


def _cell_c4fm_grant(slots: int, timed_chunks: int, chunk_blocks: int,
                     cell: str = "c4fm_grant", ppm: float = 0.0,
                     grant_from_s: float = 0.0, **kw):
    """chip_smoke.py's phase 5, the main path (``_c4fm_scene``,
    ``_c4fm_orchestrator``): 1023 slots of M = 1024 in bank mode; slot 0 a
    P25 control channel granting channel 600 (left free), whose call
    starts at 1.3 s; P25P1 voice superframes on the other 1021 from random
    starts; 3 warm-up chunks of 1024 x 5120. A nonzero `ppm` captures it
    through a tuner reading that high (``_drifted``); the control channel
    sends no grant before `grant_from_s` (``p25_streams``); `kw` goes into
    the recipe."""
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    m, full, warmup, rate = 1024, 1023, 3, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    total = warmup + timed_chunks
    n = (total + 1) * k
    grid = _grid(slots, full, TRAFFIC_INDEX)
    offsets = _offsets(grid, m, 12500.0)
    control, traffic, superframe = p25_streams(
        int(n / rate * 4800) + 64, CENTER_HZ + offsets[0], TRAFFIC_INDEX,
        grant_from_s=grant_from_s)
    base, starts = _tiled(superframe, lambda d: c4fm_modulate(d, rate),
                          rate / 4800.0, full, n, seed=0)
    free = _position(grid, TRAFFIC_INDEX)
    own = dict(zip((0, free), dibit_rows((control, traffic),
                                         lambda d: c4fm_modulate(d, rate),
                                         n)))
    rows_of = _own_rows(base, starts[grid], own, k)
    if ppm:
        rows_of = _drifted(rows_of, CENTER_HZ + offsets, ppm, rate, k)
    chunks = _cell_chunks(rows_of, fs, 12500.0, offsets, k, total, chunk)
    return chunks, _recipe(cell, "c4fm", fs, offsets, slots, chunk,
                           warmup, timed_chunks, free=free, **kw)


PPM_ERROR = 0.7                  # c4fm_ppm's tuner error: about +322 Hz
PPM_WINDOW_S = 0.4               # its observation window: about a chunk


def _cell_c4fm_ppm(slots: int, timed_chunks: int, chunk_blocks: int,
                   ppm: float = PPM_ERROR, window_s: float = PPM_WINDOW_S,
                   grant_from_s: float = 0.0):
    """The main path's scene (``_cell_c4fm_grant``) captured by a tuner
    reading `ppm` high (at PPM_ERROR the control channel's PLL reads
    about +266 Hz, 0.58 ppm, above the 0.4 ppm threshold), PPM correction
    on with a window of `window_s`, so that at 1024 x 5120 the correction
    fires in the second warm-up chunk, while the third is in flight:
    ``_apply_ppm`` retunes every active slot. Its step ``ppm`` records
    every metrics line, the corrections and the device plan after the run
    (``_watch_ppm``). A cut may move the grant (`grant_from_s`) after the
    correction, so that ``_activate`` tunes the granted slot with it."""
    chunks, recipe = _cell_c4fm_grant(
        slots, timed_chunks, chunk_blocks, cell="c4fm_ppm", ppm=ppm,
        grant_from_s=grant_from_s, ppm_correction=True,
        ppm_observation_seconds=window_s)
    recipe["steps"] = {"ppm": {}}
    return chunks, recipe


def _slot_channels() -> np.ndarray:
    """The per-slot cells' SLOT_COUNT grid channels (chip_smoke.py's
    ``_slot_channels``), within the middle half of the grid so that they
    stay in coverage at half the sample rate: a control channel, the one
    it grants SLOTS_TRAFFIC_INDEX channels above, and the voice channels
    spread over the rest."""
    m = 1024
    lo, hi = m // 4, 3 * m // 4 - 2
    traffic = lo + SLOTS_TRAFFIC_INDEX
    rest = [c for c in range(lo + 1, hi + 1) if c != traffic]
    voice_channels = rest[::len(rest) // (SLOT_COUNT - 2)][:SLOT_COUNT - 2]
    return np.array([lo, traffic, *voice_channels])


def _spread_channels() -> np.ndarray:
    """The multibank's SLOT_COUNT grid channels (chip_smoke.py's
    ``_spread_channels``): phase 5's control channel and the one it grants,
    and the others spread over the grid."""
    rest = [c for c in range(1, 1023) if c != TRAFFIC_INDEX]
    others = rest[::len(rest) // (SLOT_COUNT - 2)][:SLOT_COUNT - 2]
    return np.array([0, TRAFFIC_INDEX, *others])


def _per_slot_cell(cell: str, kind: str, slots: int, timed_chunks: int,
                   chunk_blocks: int, streams, modulate, baud: float, **kw):
    """A per-slot cell on ``_slot_channels()`` (the first `slots` of its
    31): streams(n, offsets) gives the (control, traffic, cycle) dibit
    streams of n samples; the control and traffic streams on the first
    two channels, the cycle tiled from random starts on the voice
    channels; 3 warm-up chunks of 1024 x chunk_blocks at 12.8 MS/s,
    ``bank_mode=None`` (per slot below 32 slots)."""
    m, warmup, rate = 1024, 3, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    total = warmup + timed_chunks
    n = (total + 1) * k
    grid = _grid(slots, SLOT_COUNT)
    offsets = _offsets(_slot_channels()[grid], m, 12500.0)
    control, traffic, cycle = streams(n, offsets)
    base, starts = _tiled(cycle, modulate, rate / baud, SLOT_COUNT, n,
                          seed=0)
    own = dict(zip((0, 1), dibit_rows((control, traffic), modulate, n)))
    chunks = _cell_chunks(_own_rows(base, starts[grid], own, k), fs,
                          12500.0, offsets, k, total, chunk)
    return chunks, _recipe(cell, kind, fs, offsets, slots, chunk, warmup,
                           timed_chunks, free=1, bank_mode=None, **kw)


def _cell_slots_c4fm(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_slots`` over ``_slots_loop``: the per-slot
    C4FM path at 31 slots, a control granting SLOTS_TRAFFIC_INDEX (left
    free) and 29 voice slots of P25P1 superframes. An IQ tap and a bits tap
    on the first voice slot run through the timed chunks; then a
    SAMPLE_RATE_CHANGE to 6.4 MS/s and one chunk of seeded noise
    (``_taps_and_rate_change``)."""
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    rate = 25000.0
    chunks, recipe = _per_slot_cell(
        "slots_c4fm", "c4fm", slots, timed_chunks, chunk_blocks,
        lambda n, offsets: p25_streams(int(n / rate * 4800) + 64,
                                       CENTER_HZ + offsets[0],
                                       SLOTS_TRAFFIC_INDEX),
        lambda d: c4fm_modulate(d, rate), 4800.0)
    recipe["steps"] = {
        "taps": {"slot_hz": CENTER_HZ + recipe["activate_hz"][0]},
        "rate_change": {"sample_rate": recipe["sample_rate"] / 2,
                        "noise_seed": 5}}
    return chunks, recipe


def _cell_slots_p25p2(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_slots_p25p2``: the per-slot P25 Phase 2 path
    at 31 slots; the control channel's network status MAC teaches the
    scramble key, its MAC grant activates the free slot with the key
    handed over; 29 voice slots of scrambled PTT + VOICE_4 cycles, their
    key set on activation (``prepare``)."""
    from sdrtrunk_tpu_torch.signal.generators import lsm_modulate

    rate = 25000.0
    cycle = p25p2_cycle()

    def streams(n, offsets):
        total = int(n / rate * 6000) + 64
        rng = np.random.default_rng(43)
        traffic = np.concatenate(
            [rng.integers(0, 4, int(1.3 * 6000)).astype(np.uint8)]
            + [cycle] * (total // len(cycle) + 1))
        return (p25p2_control(total, CENTER_HZ + offsets[0]), traffic,
                cycle)
    return _per_slot_cell(
        "slots_p25p2", "p25p2", slots, timed_chunks, chunk_blocks, streams,
        lambda d: lsm_modulate(d, sample_rate=rate, symbol_rate=6000.0),
        6000.0, prepare={"voice_keys": list(P25P2_KEY)})


def _cell_multibank(slots: int, timed_chunks: int, chunk_blocks: int):
    """chip_smoke.py's ``run_multibank``: ``banks=[("c4fm", 11), ("dmr",
    10), ("ltr", 10)]`` behind one channelizer on ``_spread_channels()``:
    a P25 control channel granting channel 600 (a c4fm slot left free) and
    9 C4FM voice slots; 10 DMR voice slots of the call cycle; 10 LTR
    carriers, each the voice tone plus CALL words of its own group; 2
    warm-up chunks of 1024 x 6250."""
    from sdrtrunk_tpu_torch.protocol.ltr.messages import ltr_encode_word
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    if slots != SLOT_COUNT:
        raise ValueError(f"the multibank's banks hold {SLOT_COUNT} slots, "
                         f"not {slots}")
    m, warmup, rate = 1024, 2, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    total = warmup + timed_chunks
    n = (total + 1) * k
    n_c4fm, n_dmr, n_ltr = (b for _, b in MULTIBANK)
    offsets = _offsets(_spread_channels(), m, 12500.0)
    mod = lambda d: c4fm_modulate(d, rate)  # noqa: E731
    control, traffic, superframe = p25_streams(
        int(n / rate * 4800) + 64, CENTER_HZ + offsets[0], TRAFFIC_INDEX)
    call = dmr_streams(int(n / rate * 4800) + 64)[2]
    own = dibit_rows((control, traffic), mod, n)
    c4fm_base, c4fm_starts = _tiled(superframe, mod, rate / 4800.0,
                                    n_c4fm - 2, n, 0)
    dmr_base, dmr_starts = _tiled(call, mod, rate / 4800.0, n_dmr, n, 1)
    rng = np.random.default_rng(17)
    ident = [(b % 5 + 1, 10 * b + 3) for b in range(n_ltr)]
    words = np.stack([ltr_encode_word(0, h, h, g, h) for h, g in ident])
    start = rng.integers(0, 40 * 84, n_ltr)
    phase = rng.uniform(0, 2 * np.pi, n_ltr)
    fm = _FM(n_ltr, rate)
    span = np.arange(k)[None, :]

    def rows_of(j):
        return np.concatenate([
            own[:, j * k:(j + 1) * k],
            c4fm_base[c4fm_starts[:, None] + j * k + span],
            dmr_base[dmr_starts[:, None] + j * k + span],
            fm(0.35 * _square_fsk(words, j * k, k, rate / 300.0, start)
               + 0.5 * _tone(j * k, k, rate, VOICE_TONE_HZ, phase))])
    chunks = _cell_chunks(rows_of, fs, 12500.0, offsets, k, total, chunk)
    kinds = ["c4fm"] * (n_c4fm - 2) + ["dmr"] * n_dmr + ["ltr"] * n_ltr
    recipe = _recipe("multibank", "c4fm", fs, offsets, slots, chunk, warmup,
                     timed_chunks, free=1, kinds=kinds, decoder=None,
                     bank_mode=None, banks=[list(b) for b in MULTIBANK])
    del recipe["kwargs"]["slots"]              # the banks' sum
    return chunks, recipe


# cell -> (its builder, then its slots, timed chunks and chunk blocks at
# full width)
CELLS = {"ltr": (_cell_ltr, 1023, 4, 6250),
         "mpt1327": (_cell_mpt1327, 1023, 3, 6250),
         "lsm": (_cell_lsm, 64, 2, 5120),
         "am": (_cell_am, 64, 2, 6400),
         "c4fm_25k": (_cell_c4fm_25k, 511, 3, 5120)}
# the main path's grant, the per-slot tier and banks= (PATHS_FILE's), the
# same way
PATHS = {"c4fm_grant": (_cell_c4fm_grant, 1023, 4, 5120),
         "slots_c4fm": (_cell_slots_c4fm, SLOT_COUNT, 4, 5120),
         "slots_p25p2": (_cell_slots_p25p2, SLOT_COUNT, 4, 5120),
         "multibank": (_cell_multibank, SLOT_COUNT, 4, 6250),
         "c4fm_ppm": (_cell_c4fm_ppm, 1023, 4, 5120)}

# cell bytes kept by ``cell_bytes(..., keep=True)``: the main path's scene
# is built once for its in-process, worker and monitor holds
_KEPT: dict = {}


def cell_bytes(cell: str, slots: int | None = None,
               timed_chunks: int | None = None,
               chunk_blocks: int | None = None, keep: bool = False):
    """A cell's (``CELLS`` or ``PATHS``) int8 chunks and its recipe
    (``orchestrator_from_recipe``), at full width where an argument is
    None: NumPy on the host, the same bytes on every machine. Imports the
    port's host modules only. With `keep` the bytes are kept for the next
    call with `keep` and the same arguments (the recipe is a copy)."""
    build, *full = {**CELLS, **PATHS}[cell]
    given = tuple(f if g is None else g for g, f in
                  zip((slots, timed_chunks, chunk_blocks), full))
    if not keep:
        return build(*given)
    if (cell, given) not in _KEPT:
        _KEPT[cell, given] = build(*given)
    chunks, recipe = _KEPT[cell, given]
    return chunks, json.loads(json.dumps(recipe))


def orchestrator_from_recipe(recipe: dict, chunks, orchestrator,
                             identifiers, band=None, **kw):
    """A cell's Orchestrator from its recipe in either package: that
    package's ``Orchestrator``, ``IdentifierCollection`` and
    ``FrequencyBand`` classes are passed in, with its own keyword
    arguments `kw` (the port's ``device``). The recipe's ``prepare``
    (``_prepare_orchestrator``) runs last."""
    if recipe["channel_map"] is not None:
        kw["channel_map"] = band(**recipe["channel_map"])
    args = recipe["kwargs"]
    orch = orchestrator(_chunk_source(chunks, args["chunk_samples"]),
                        recipe["sample_rate"], recipe["center_hz"],
                        [recipe["control_offset_hz"]], **args, **kw)
    kinds = recipe.get("activate_kinds") or [None] * len(
        recipe["activate_hz"])
    for off, kind in zip(recipe["activate_hz"], kinds):
        extra = {} if kind is None else {"kind": kind}
        orch._activate(recipe["center_hz"] + off, identifiers(), **extra)
    if sum(s.active for s in orch.slots) != \
            len(orch.slots) - recipe["free_slots"]:
        raise AssertionError(f"{recipe['cell']}: slots did not all "
                             f"activate")
    _prepare_orchestrator(orch, recipe.get("prepare") or {})
    return orch


def _prepare_orchestrator(orch, prepare: dict) -> None:
    """A recipe's ``prepare``: {"voice_keys": [WACN, system, NAC]} sets
    that scramble key on every active per-slot voice slot, as a P25 Phase
    2 control channel's preload does for a slot it grants (chip_smoke.py's
    ``set_voice_keys``)."""
    key = prepare.get("voice_keys")
    if key is None:
        return
    for s in orch.slots:
        if s.active and not s.is_control:
            s.processor.framer.set_scramble_parameters(*key)
            s.processor.state.scramble_key = tuple(key)


def _scene_cell(cell: str, slots: int, timed_chunks: int,
                chunk_blocks: int, keep: bool = False, **kw) -> BankScene:
    """A cell's bytes and the port's Orchestrator over them; `kw` goes
    into the recipe's keyword arguments."""
    from sdrtrunk_tpu_torch import resolve_device
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand

    chunks, recipe = cell_bytes(cell, slots, timed_chunks, chunk_blocks,
                                keep=keep)
    recipe["kwargs"].update(kw)
    orch = orchestrator_from_recipe(recipe, chunks, Orchestrator,
                                    IdentifierCollection, FrequencyBand,
                                    device=resolve_device(None))
    return BankScene(recipe["kind"], orch, chunks, recipe["warmup"],
                     recipe["timed_chunks"], _segment_slots(orch),
                     recipe=recipe)


def scene_bank_ltr(slots: int = 1023, timed_chunks: int = 4,
                   chunk_blocks: int = 6250) -> BankScene:
    """The LTR cell (``_cell_ltr``) on the port: the mixed bank, its bit
    timing at W = 53."""
    return _scene_cell("ltr", slots, timed_chunks, chunk_blocks)


def scene_bank_mpt1327(slots: int = 1023, timed_chunks: int = 3,
                       chunk_blocks: int = 6250) -> BankScene:
    """The MPT1327 cell (``_cell_mpt1327``) on the port: the AFSK bit
    timing at W = 12 and a grant through the channel map."""
    return _scene_cell("mpt1327", slots, timed_chunks, chunk_blocks)


def scene_bank_lsm(slots: int = 64, timed_chunks: int = 2,
                   chunk_blocks: int = 5120) -> BankScene:
    """The LSM cell (``_cell_lsm``) on the port: Gardner at W = 11."""
    return _scene_cell("lsm", slots, timed_chunks, chunk_blocks)


def scene_bank_am(slots: int = 64, timed_chunks: int = 2,
                  chunk_blocks: int = 6400) -> BankScene:
    """The AM cell (``_cell_am``) on the port: no kernel."""
    return _scene_cell("am", slots, timed_chunks, chunk_blocks)


def scene_bank_c4fm_25k(slots: int = 511, timed_chunks: int = 3,
                        chunk_blocks: int = 5120) -> BankScene:
    """The C4FM cell on 25 kHz channels (``_cell_c4fm_25k``) on the port:
    DQPSK at W = 20 and a grant at 25 kHz spacing."""
    return _scene_cell("c4fm_25k", slots, timed_chunks, chunk_blocks)


def scene_bank_c4fm_grant(slots: int = 1023, timed_chunks: int = 4,
                          chunk_blocks: int = 5120) -> BankScene:
    """The main path's scene (``_cell_c4fm_grant``) on the port: the C4FM
    bank tier, DQPSK at W = 10, a grant of channel 600 at 12.5 kHz; its
    bytes are kept for ``scene_bank_worker`` and ``monitor_wave``."""
    return _scene_cell("c4fm_grant", slots, timed_chunks, chunk_blocks,
                       keep=True)


def scene_bank_c4fm_ppm(slots: int = 1023, timed_chunks: int = 4,
                        chunk_blocks: int = 5120, **kw) -> BankScene:
    """The main path's scene through a tuner reading PPM_ERROR high
    (``_cell_c4fm_ppm``) on the port: the PPM correction fires and
    retunes every active slot; `kw` goes into the recipe's keyword
    arguments (a tier: ``host_process``, ``bank_mode``, ``banks``)."""
    return _scene_cell("c4fm_ppm", slots, timed_chunks, chunk_blocks, **kw)


def scene_bank_worker(slots: int = 1023, timed_chunks: int = 4,
                      chunk_blocks: int = 5120) -> BankScene:
    """The main path's scene with ``host_process=True``: the bank's host
    layer in a worker process, on ``scene_bank_c4fm_grant``'s bytes and
    depth, so that what its parent sees (``worker_view``) is held to the
    in-process run's. Close its Orchestrator after use."""
    return _scene_cell("c4fm_grant", slots, timed_chunks, chunk_blocks,
                       keep=True, host_process=True)


def scene_bank_slots_c4fm(slots: int = SLOT_COUNT, timed_chunks: int = 4,
                          chunk_blocks: int = 5120) -> BankScene:
    """The per-slot C4FM cell (``_cell_slots_c4fm``) on the port: DQPSK at
    W = 10 over 31 slots, the recording taps and a sample-rate change
    (``run_bank`` runs the recipe's steps)."""
    return _scene_cell("slots_c4fm", slots, timed_chunks, chunk_blocks)


def scene_bank_slots_p25p2(slots: int = SLOT_COUNT, timed_chunks: int = 4,
                           chunk_blocks: int = 5120) -> BankScene:
    """The per-slot P25 Phase 2 cell (``_cell_slots_p25p2``) on the port:
    Gardner at W = 16 over 31 slots and the key handed to a grant."""
    return _scene_cell("slots_p25p2", slots, timed_chunks, chunk_blocks)


def scene_bank_multibank(slots: int = SLOT_COUNT, timed_chunks: int = 4,
                         chunk_blocks: int = 6250) -> BankScene:
    """The multibank cell (``_cell_multibank``) on the port: DQPSK at gain
    0.3 and 0.4 and the bit timing at W = 53, one launch a bank a chunk."""
    return _scene_cell("multibank", slots, timed_chunks, chunk_blocks)


def monitor_inputs(directory, slots: int | None = None,
                   timed_chunks: int | None = None,
                   chunk_blocks: int | None = None) -> dict:
    """chip_smoke.py's ``run_monitor`` on the main path's bytes
    (``cell_bytes("c4fm_grant", ...)``, kept): writes them to directory as
    a 16-bit IQ wave (complex64 / 128, ``scene.wav``) and a playlist of the
    control channel alone (``p.json``), and returns the ``monitor``
    command a user runs on them (``--bank --traffic-slots`` all but the
    control's slot, the chunk, as many chunks as the wave holds, every
    other setting at its default; the audio under ``audio/``, the event
    log ``events.jsonl``) with those paths: {"argv", "wave", "audio",
    "events"}."""
    from sdrtrunk_tpu_torch.config import (ChannelConfig, DecodeConfig,
                                           Playlist, SourceConfig)
    from sdrtrunk_tpu_torch.io.wave import write_complex_wave

    chunks, recipe = cell_bytes("c4fm_grant", slots, timed_chunks,
                                chunk_blocks, keep=True)
    directory = Path(directory)
    wave, playlist = directory / "scene.wav", directory / "p.json"
    iq = np.concatenate([c[:, 0] + 1j * c[:, 1] for c in chunks]
                        ).astype(np.complex64) / 128.0
    write_complex_wave(wave, iq, int(recipe["sample_rate"]))
    del iq
    Playlist(channels=[ChannelConfig(
        name="Control", system="Scene", site="Site1",
        source=SourceConfig(frequency_hz=recipe["center_hz"]
                            + recipe["control_offset_hz"]),
        decode=DecodeConfig(decoder="p25p1"))]).save(playlist)
    audio, events = directory / "audio", directory / "events.jsonl"
    args = recipe["kwargs"]
    argv = ["monitor", "--playlist", playlist, "--input", wave,
            "--center-frequency", recipe["center_hz"], "--bank",
            "--traffic-slots", args["slots"] - 1,
            "--chunk-samples", args["chunk_samples"],
            "--max-chunks", len(chunks), "--audio-dir", audio,
            "--event-log", events]
    return {"argv": [str(a) for a in argv], "wave": wave, "audio": audio,
            "events": events}


MIXED_CHUNKS = 6                 # the mixed monitor: 6 chunks of 1024 x 6250
MIXED_BLOCKS = 6250
MIXED_SLOTS = 4                  # --traffic-slots: banks of 1 + 4 slots
MIXED_CHANNELS = {"p25": 0, "p25_traffic": 610, "dmr": 300,
                  "dmr_traffic": TRAFFIC_INDEX, "ltr": 900}
LTR_IDENT = (3, 33)              # the LTR control channel's (home, group)


def mixed_monitor_bytes(chunks: int = MIXED_CHUNKS,
                        chunk_blocks: int = MIXED_BLOCKS):
    """chip_smoke.py's ``run_monitor_mixed`` scene on the host: three
    control channels of the 1023-channel grid at 12.8 MS/s, P25 Phase 1
    (its IDEN_UP announcing band 0, granting channel 610 there), DMR (the
    TSCC's aloha and Tier III grants of channel 600) and LTR (the voice
    tone under CALL words of LTR_IDENT's group), and the two granted
    channels' calls; `chunks` chunks of 1024 x chunk_blocks (K a multiple
    of 25 for the LTR bank), one peak, rounded (``_cell_chunks``). Returns
    (the int8 chunks, {name: its RF frequency})."""
    from sdrtrunk_tpu_torch.protocol.ltr.messages import ltr_encode_word
    from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

    m, rate = 1024, 25000.0
    fs, chunk = m * 12500.0, m * chunk_blocks
    k = 2 * chunk // m
    n = (chunks + 1) * k
    offsets = _offsets(np.array(list(MIXED_CHANNELS.values())), m, 12500.0)
    hz = dict(zip(MIXED_CHANNELS, CENTER_HZ + offsets))
    dibits = int(n / rate * 4800) + 64
    control, traffic, _ = p25_streams(
        dibits, hz["p25"],
        MIXED_CHANNELS["p25_traffic"] - MIXED_CHANNELS["p25"], band_id=0)
    dmr_control, dmr_traffic, _ = dmr_streams(dibits)
    rng = np.random.default_rng(23)
    word = ltr_encode_word(0, LTR_IDENT[0], *LTR_IDENT, LTR_IDENT[0])[None]
    data = 0.35 * _square_fsk(word, 0, n, rate / 300.0, np.zeros(1, int))
    streams = np.concatenate([
        dibit_rows((control, traffic, dmr_control, dmr_traffic),
                   lambda d: c4fm_modulate(d, rate), n),
        fm_streams(data + voice(1, n, rate, rng, 0.5), rate)])
    return _cell_chunks(lambda j: streams[:, j * k:(j + 1) * k], fs,
                        12500.0, offsets, k, chunks, chunk), hz


def mixed_monitor_inputs(directory, chunks: int = MIXED_CHUNKS,
                         chunk_blocks: int = MIXED_BLOCKS) -> dict:
    """chip_smoke.py's ``run_monitor_mixed`` on the host-built bytes
    (``mixed_monitor_bytes``, its arguments): writes them to directory as
    a 16-bit IQ wave (``mixed.wav``) and a playlist of the three control
    channels
    (``mixed.json``: P25 recording its demodulated bits, DMR, LTR
    recording its calls as mp2, so that every call is written as mp2),
    and returns the ``monitor ... --traffic-slots MIXED_SLOTS`` command a
    user runs on them (the calls and the bits tap ``P25.bits`` under
    ``audio/``, the event log ``audio/events.jsonl``) with those paths and
    the last chunk as complex64 (a device-time measurement's input):
    {"argv", "wave", "audio", "events", "last"}."""
    from sdrtrunk_tpu_torch.config import (ChannelConfig, DecodeConfig,
                                           Playlist, RecordConfig,
                                           SourceConfig)
    from sdrtrunk_tpu_torch.io.wave import write_complex_wave

    iq8, hz = mixed_monitor_bytes(chunks, chunk_blocks)
    directory = Path(directory)
    wave, playlist = directory / "mixed.wav", directory / "mixed.json"
    iq = np.concatenate([c[:, 0] + 1j * c[:, 1] for c in iq8]
                        ).astype(np.complex64) / 128.0
    write_complex_wave(wave, iq, int(1024 * 12500.0))
    del iq
    Playlist(channels=[
        ChannelConfig(name="P25", source=SourceConfig(frequency_hz=hz["p25"]),
                      decode=DecodeConfig(decoder="p25p1"),
                      record=RecordConfig(demodulated_bits=True)),
        ChannelConfig(name="DMR", source=SourceConfig(frequency_hz=hz["dmr"]),
                      decode=DecodeConfig(decoder="dmr")),
        ChannelConfig(name="LTR", source=SourceConfig(frequency_hz=hz["ltr"]),
                      decode=DecodeConfig(decoder="ltr"),
                      record=RecordConfig(audio=True, audio_format="mp2"))]
    ).save(playlist)
    audio = directory / "audio"
    events = audio / "events.jsonl"
    argv = ["monitor", "--playlist", playlist, "--input", wave,
            "--center-frequency", CENTER_HZ, "--traffic-slots", MIXED_SLOTS,
            "--chunk-samples", 1024 * chunk_blocks,
            "--max-chunks", chunks, "--audio-dir", audio,
            "--event-log", events]
    return {"argv": [str(a) for a in argv], "wave": wave, "audio": audio,
            "events": events,
            "last": (iq8[-1][:, 0] + 1j * iq8[-1][:, 1]).astype(
                np.complex64) / 128.0}


def run_bank(scene: BankScene) -> dict:
    """Run a scene as its bench leg does: the warm-up chunks, then the
    timed ones; returns the leg's record. A cell recipe's ``steps``
    (``_run_steps``) run around the timed chunks and record into
    ``scene.steps``."""
    orch = scene.orch
    chunk = orch.chunk_samples
    fs = orch.sample_rate
    steps = (scene.recipe or {}).get("steps") or {}
    ppm = _watch_ppm(orch) if "ppm" in steps else None
    orch.run(max_chunks=scene.warmup)          # kernel load + acquisition
    with tempfile.TemporaryDirectory() as tmp:
        taps = (_start_taps(orch, Path(tmp), **steps["taps"])
                if "taps" in steps else None)
        t0 = time.perf_counter()
        metrics = orch.run(max_chunks=scene.timed_chunks)
        elapsed = time.perf_counter() - t0
        if taps is not None:
            scene.steps["taps"] = _stop_taps(orch, *taps)
    if "rate_change" in steps:
        scene.steps["rate_change"] = _rate_change(orch,
                                                  **steps["rate_change"])
    msps = chunk * scene.timed_chunks / elapsed / 1e6
    record = {"msps": msps, "realtime_factor": msps * 1e6 / fs,
              "slots": len(orch.slots)}
    if ppm is not None:
        scene.steps["ppm"], record["ppm_wall"] = _ppm_record(orch, *ppm)
    if scene.kind == "c4fm":
        record["active_channels"] = metrics.get("active_channels")
    elif scene.kind in ("dmr", "p25p2"):
        record["timeslots"] = 2 * len(orch.slots)
    record.update({"wideband_rate_msps": fs / 1e6, "chunk_samples": chunk,
                   "chunks": scene.timed_chunks})
    if scene.kind in ("nbfm", "am"):
        record["channels_with_audio"] = int(sum(
            1 for mdl in orch.bank_proc.modules
            if mdl.segment is not None and mdl.segment.duration > 1.0))
    else:
        decoded = sum(s["frames"] for s in orch.channel_status())
        record["fragments_decoded" if scene.kind == "p25p2"
               else "frames_decoded"] = int(decoded)
        record["audio_segments"] = len(orch.audio_segments)
    record["ingest_format"] = _ingest_label(scene.ingest)
    return record


# ``_run_steps``: a cell recipe's steps, run by ``run_bank`` in either
# package. "taps": {"slot_hz": f} records the wideband IQ and the dibits of
# the slot at f through the timed chunks (``_start_taps``, ``_stop_taps``);
# "rate_change": {"sample_rate": r, "noise_seed": s} then sends a tuner's
# SAMPLE_RATE_CHANGE to r and runs one chunk of seeded noise
# (``_rate_change``); "ppm": {} records what the PPM correction did over
# the whole run (``_watch_ppm``, ``_ppm_record``).

def _watch_ppm(orch):
    """Keep every metrics line (and the host clock at which it came) and
    time each correction the PPM monitor applies (the retune of every
    active slot, ``_apply_ppm``); returns (lines, times, applies)."""
    lines, times, applies = [], [], []

    def sink(line):
        lines.append(json.loads(line))
        times.append(time.perf_counter())
    orch.metrics_sink = sink
    monitor = orch.ppm_monitor
    correct = monitor.on_correct

    def on_correct(ppm):
        t0 = time.perf_counter()
        correct(ppm)
        applies.append((len(lines), (time.perf_counter() - t0) * 1e3))
    monitor.on_correct = on_correct
    return lines, times, applies


def _ppm_record(orch, lines, times, applies):
    """(what the PPM correction did, the wall ms around it). The first:
    each metrics line's (t, correction_ppm, pll_error_hz), the monitor's
    corrections [(t, ppm)], the correction in force and the device plan
    of each active slot after the run ([slot, its frequency, bin, bin,
    step], the step in rad/sample at the channel rate, float64). The
    second: for each correction its line's index, the ms its retune took,
    the wall ms of the chunk that fired it (between its line and the one
    before) and the median of the other chunks'."""
    steps = np.asarray(orch.steps, np.float64)
    record = {
        "lines": [[r["t"], r.get("correction_ppm"), r.get("pll_error_hz")]
                  for r in lines],
        "corrections": [[float(t), float(p)]
                        for t, p in orch.ppm_monitor.corrections],
        "correction_ppm": float(orch.correction_ppm),
        "channel_rate": float(orch.rx.channelizer.channel_sample_rate),
        "plan": [[s.index, float(s.frequency_hz),
                  *map(int, orch.bins[s.index]), float(steps[s.index])]
                 for s in orch.slots if s.active]}
    gaps = np.diff(times) * 1e3
    fired = [i for i, _ in applies]
    wall = [{"line": i, "apply_ms": ms,
             "chunk_wall_ms": float(gaps[i - 1]) if i else None}
            for i, ms in applies]
    others = [g for j, g in enumerate(gaps, 1) if j not in fired]
    return record, {"corrections": wall,
                    "other_chunks_wall_ms_median":
                        float(np.median(others)) if others else None}


def _start_taps(orch, tmp: Path, slot_hz: float):
    slot = next(s.index for s in orch.slots
                if s.active and abs(s.frequency_hz - slot_hz) < 1.0)
    orch.start_iq_recording(tmp / "wideband_iq.wav")
    orch.start_bits_recording(slot, tmp / "slot.bits")
    return tmp, slot


def _stop_taps(orch, tmp: Path, slot: int) -> dict:
    """The taps' files after they were stopped: the IQ wave's sha256,
    samples and rate, the bits file's sha256 and bytes."""
    import wave

    orch.stop_iq_recording()
    orch.stop_bits_recording(slot)
    iq, bits = tmp / "wideband_iq.wav", tmp / "slot.bits"
    with wave.open(str(iq), "rb") as wf:
        frames, rate = wf.getnframes(), wf.getframerate()
    return {"slot": slot, "iq_sha256": _file_sha(iq), "iq_samples": frames,
            "iq_rate": rate, "bits_sha256": _file_sha(bits),
            "bits_bytes": bits.stat().st_size}


def _rate_change(orch, sample_rate: float, noise_seed: int) -> dict:
    """A SAMPLE_RATE_CHANGE through ``orch.on_source_event`` (the event
    class of the orchestrator's own package), then one chunk of noise
    (int8 in [-20, 20], drawn from noise_seed); what the rebuild gave: the
    rate, bins and chunk, each slot's (frequency, active), the device plan
    (bins, steps), the noise chunk's metrics line (its sample-clock keys)
    and the samples consumed."""
    import importlib

    tuner = importlib.import_module(
        type(orch).__module__.split(".")[0] + ".sources.tuner")
    orch.on_source_event(tuner.SourceEvent(
        tuner.SourceEventType.SAMPLE_RATE_CHANGE, value=sample_rate))
    rng = np.random.default_rng(noise_seed)
    orch.source = lambda n: rng.integers(-20, 21, (n, 2)).astype(np.int8)
    metrics = orch.run(max_chunks=1)
    return {"sample_rate": float(orch.sample_rate),
            "bins": int(orch.rx.channelizer.channels),
            "chunk_samples": int(orch.chunk_samples),
            "slots": [[float(s.frequency_hz), bool(s.active)]
                      for s in orch.slots],
            "plan_bins": np.asarray(orch.bins).tolist(),
            "plan_steps": [float(v) for v in np.asarray(orch.steps)],
            "metrics": _clock_metrics(metrics),
            "samples": int(orch.samples_processed)}


def _clock_metrics(metrics: dict) -> dict:
    """A metrics line without its wall-clock keys (the upload's ms and
    MB/s)."""
    return {k: v for k, v in metrics.items() if not k.startswith("upload_")}


def bench_orchestrator_bank(slots: int = 1023, timed_chunks: int = 4,
                            chunk_blocks: int = 5120,
                            ingest: str = "auto") -> dict:
    """The C4FM bank leg (``scene_orchestrator_bank``) run and timed:
    realtime_factor >= 1.0 means the product loop keeps up with 1023
    channels."""
    return run_bank(scene_orchestrator_bank(slots, timed_chunks,
                                            chunk_blocks, ingest))


def bench_orchestrator_bank_dmr(slots: int = 1023, timed_chunks: int = 4,
                                chunk_blocks: int = 5120,
                                host_process: bool = False,
                                ingest: str = "auto") -> dict:
    """The DMR bank leg (``scene_orchestrator_bank_dmr``) run and timed."""
    return run_bank(scene_orchestrator_bank_dmr(
        slots, timed_chunks, chunk_blocks, host_process, ingest))


def bench_orchestrator_bank_p25p2(slots: int = 1023,
                                  timed_chunks: int = 4,
                                  chunk_blocks: int = 5120,
                                  host_process: bool = False,
                                  ingest: str = "auto") -> dict:
    """The P25 Phase 2 bank leg (``scene_orchestrator_bank_p25p2``) run
    and timed."""
    return run_bank(scene_orchestrator_bank_p25p2(
        slots, timed_chunks, chunk_blocks, host_process, ingest))


def bench_orchestrator_bank_nbfm(slots: int = 1023, timed_chunks: int = 6
                                 ) -> dict:
    """The analog bank leg (``scene_orchestrator_bank_nbfm``) run and
    timed."""
    return run_bank(scene_orchestrator_bank_nbfm(slots, timed_chunks))


# ------------------------------------------------------------- digests

# hex digits kept of a slot's hashes, so that five 1023-slot digests stay
# small (tests/torch_reference/banks_1023.json)
SLOT_HASH_HEX = 8


def _sha(obj) -> str:
    """sha256 of obj's canonical JSON (sorted keys, no spaces)."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True,
                                     separators=(",", ":")).encode()
                          ).hexdigest()


def _ids(identifiers) -> list:
    """An IdentifierCollection as sorted strings."""
    return sorted(f"{i.identifier_class.value}/{i.form.value}/"
                  f"{i.role.value}/{i.protocol}/{i.value}"
                  for i in identifiers.all())


def _segment_row(frequency_hz: float, seg) -> list:
    """One AudioSegment as the digest holds it: its slot's frequency,
    timeslot, sample count, complete, and its identifiers as sorted
    strings."""
    return [float(frequency_hz), int(seg.timeslot), len(seg.samples),
            bool(seg.complete), _ids(seg.identifiers)]


def _event_row(event) -> list:
    """A decode event as the digest holds it: what the signal decided
    (kind, protocol, frequency, timeslot, details, identifiers) and its
    start on the orchestrator's sample clock (samples consumed over the
    sample rate)."""
    return [event.event_type.name, event.protocol,
            None if event.frequency_hz is None else float(event.frequency_hz),
            int(event.timeslot), float(event.time_start), event.details,
            _ids(event.identifiers)]


def _plain(value):
    """A decoded message as plain data both packages give: enums by name
    (each package has its own copy of an enum), arrays as lists, objects
    by their fields."""
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "__dict__"):
        return {k: _plain(v) for k, v in vars(value).items()}
    return value


def _file_sha(path) -> str:
    """sha256 of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _chunk_hashes(chunks) -> list:
    return [hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest()
            for c in chunks]


# the analog-trunking kinds: a slot of theirs has messages and an analog
# audio module
_TRUNKING_KINDS = ("ltr", "ltrnet", "passport", "mpt1327")


def bank_digest(orch, chunks, segments, events: bool = False,
                steps: dict | None = None) -> dict:
    """What a bank decoded, slot by slot, in a form both packages give
    (duck-typed over ``channel_status()``, ``audio_segments``, ``events``
    and, for an analog bank, ``bank_proc.modules``, for a mixed one
    ``bank_proc.procs``, on the per-slot tier and with ``banks=`` the
    slots' processors; imports neither JAX nor torch).

    chunks: the int8 chunks fed; segments: the scene's (slot,
    AudioSegment) pairs (``_segment_slots``), which must be every segment
    of ``orch.audio_segments`` in its order. Holds the sha256 of every
    chunk; per slot the frames (fragments for P25 Phase 2), the sha256 of
    its metrics dict, its audio segments' count and the sha256 of their
    rows (``_segment_row``), the slot hashes cut to ``SLOT_HASH_HEX``
    digits; for an analog, a mixed or a ``banks=`` bank also per slot the
    audio samples (its segments', the open one's included), ``open`` (1
    where an analog segment is open at the end) and the audio's RMS; for a
    mixed bank, and for an analog-trunking slot of ``banks=``, per slot the
    sha256 of its decoded messages in order (``_plain``); on the per-slot
    P25 Phase 2 tier each slot's scramble key; with `events` the sha256 of
    ``orch.events`` (``_event_row``) and their count
    (tests/torch_reference/banks_1023.json predates it); `steps` (a
    scene's, ``run_bank``) as they are; and the totals."""
    status = orch.channel_status()
    drained = [seg for _, seg in segments]
    if len(drained) != len(orch.audio_segments) or any(
            a is not b for a, b in zip(drained, orch.audio_segments)):
        raise ValueError("bank_digest: the orchestrator's audio segments "
                         "are not the ones drained beside their slots")
    freq = [float(s["frequency_hz"]) for s in status]
    by_slot = [[] for _ in status]
    for slot, seg in segments:
        by_slot[slot].append(seg)
    rows = [[_segment_row(f, seg) for seg in segs]
            for f, segs in zip(freq, by_slot)]
    cut = SLOT_HASH_HEX
    digest = {
        "slots": len(status),
        "chunks": _chunk_hashes(chunks),
        "frequencies": _sha(freq),
        "frames": [int(s["frames"]) for s in status],
        "metrics": [_sha(s["metrics"])[:cut] for s in status],
        "segments": [len(r) for r in rows],
        "segments_sha": [_sha(r)[:cut] for r in rows],
    }
    totals = {"frames": sum(digest["frames"]), "segments": len(drained)}
    modules = procs = None
    if getattr(orch, "bank_analog", False):
        modules = orch.bank_proc.modules
    elif getattr(orch, "bank_mixed", False):
        procs = orch.bank_proc.procs
    elif getattr(orch, "banks", None) is not None:
        procs = [s.processor if s.kind in _TRUNKING_KINDS else None
                 for s in orch.slots]
    if procs is not None:
        modules = [None if p is None else p.audio for p in procs]
        digest["messages"] = [
            _sha([] if p is None else [_plain(m) for m in p.messages])[:cut]
            for p in procs]
        totals["messages"] = sum(len(p.messages) for p in procs
                                 if p is not None)
    if modules is not None:
        opened = [m is not None and m.segment is not None for m in modules]
        audio = [[seg.samples for seg in segs] for segs in by_slot]
        for s, mdl in enumerate(modules):
            if opened[s]:
                audio[s].append(mdl.segment.samples)
        flat = [np.concatenate(a) if a else np.zeros(0, np.float32)
                for a in audio]
        digest["audio_samples"] = [int(len(a)) for a in flat]
        digest["open"] = [int(o) for o in opened]
        digest["rms"] = [float(np.sqrt(np.mean(np.square(
            a, dtype=np.float64)))) if len(a) else 0.0 for a in flat]
        totals.update(audio_samples=sum(digest["audio_samples"]),
                      open=sum(digest["open"]))
    if not orch.bank_mode and getattr(orch, "banks", None) is None \
            and orch.decoder_name == "p25p2":
        digest["keys"] = [None if s.processor is None
                          else _plain(s.processor.state.scramble_key)
                          for s in orch.slots]
    if events:
        digest["events"] = _sha([_event_row(e) for e in orch.events])
        totals["events"] = len(orch.events)
    digest.update(steps or {})
    digest["totals"] = totals
    return digest


def worker_view(orch, chunks) -> dict:
    """What the parent of a ``host_process=True`` bank sees, in the form
    an in-process run of the same bank gives too: the chunk hashes, the
    frames of each slot (``channel_status()``; the worker sends no
    per-slot metrics), the sha256 of the events (``_event_row``) and of
    the AudioSegment rows in ``orch.audio_segments``' order (the worker's
    arrive without their slot, so a row has no frequency), and the
    totals. ``compare_digests`` holds two views."""
    status = orch.channel_status()
    rows = [_segment_row(0.0, seg)[1:] for seg in orch.audio_segments]
    frames = [int(s["frames"]) for s in status]
    return {"slots": len(status), "chunks": _chunk_hashes(chunks),
            "frequencies": _sha([float(s["frequency_hz"]) for s in status]),
            "frames": frames, "segment_rows": _sha(rows),
            "events": _sha([_event_row(e) for e in orch.events]),
            "totals": {"frames": sum(frames), "segments": len(rows),
                       "events": len(orch.events)}}


# the per-slot fields ``compare_digests`` holds equal, RMS apart, and the
# fields it holds equal whole
_SLOT_FIELDS = ("frames", "metrics", "segments", "segments_sha",
                "audio_samples", "open", "messages", "keys")
_WHOLE_FIELDS = ("events", "segment_rows", "taps", "rate_change")


def compare_digests(got: dict, want: dict, tolerance: dict) -> dict:
    """Hold a bank's digest (``bank_digest``, or a ``worker_view``) to the
    reference's, slot by slot, within ``tolerance``:

    * ``slots_differing``: the most slots on which a field differs
      (default 0), ``may_differ`` the fields that may (default: any
      per-slot field);
    * ``frames_per_slot``: the most frames a slot may be off by (default
      0; null: no bound);
    * ``totals_share``: {"frames": x, "segments": y}, the most each total
      may be off by as a share of the reference's (default: no bound);
    * ``rms_rel``: the relative RMS difference allowed (default 0);
    * ``ppm``: the bounds of ``compare_ppm``, for a digest with a "ppm"
      step.

    The chunk hashes, the slot count and the frequencies are always held
    equal, and so are the whole fields (``_WHOLE_FIELDS``: the events, a
    view's segment rows, a scene's steps; the "ppm" step within
    ``compare_ppm``'s bounds) where the reference's digest has them,
    unless ``may_differ`` names them. Returns {"ok", "chunks_equal",
    "events_equal", "differing": [{slot, field: [got, want], ...}],
    "whole_differing": {field: [got, want]}, "totals": {field: [got,
    want]}} and, with a "ppm" step, "ppm" (``compare_ppm``'s)."""
    rms_rel = tolerance.get("rms_rel", 0.0)
    differing = []
    same_shape = (got["slots"] == want["slots"]
                  and got["frequencies"] == want["frequencies"])
    if same_shape:
        for s in range(want["slots"]):
            row = {f: [got[f][s], want[f][s]] for f in _SLOT_FIELDS
                   if f in want and got[f][s] != want[f][s]}
            if "rms" in want and abs(got["rms"][s] - want["rms"][s]) > \
                    rms_rel * abs(want["rms"][s]):
                row["rms"] = [got["rms"][s], want["rms"][s]]
            if row:
                differing.append({"slot": s, **row})
    fields = {f for d in differing for f in d if f != "slot"}
    frames_off = max((abs(d["frames"][0] - d["frames"][1])
                      for d in differing if "frames" in d), default=0)
    per_slot = tolerance.get("frames_per_slot", 0)
    totals = {k: [got["totals"][k], v] for k, v in want["totals"].items()}
    shares_ok = all(abs(totals[k][0] - totals[k][1])
                    <= share * abs(totals[k][1])
                    for k, share in tolerance.get("totals_share", {}).items())
    chunks_equal = got["chunks"] == want["chunks"]
    whole = {f: [got.get(f), want[f]] for f in _WHOLE_FIELDS
             if f in want and got.get(f) != want[f]}
    extra = {}
    if "ppm" in want:
        extra["ppm"] = compare_ppm(got.get("ppm"), want["ppm"],
                                   tolerance.get("ppm", {}))
        if not extra["ppm"]["ok"]:
            whole["ppm"] = [got.get("ppm"), want["ppm"]]
    fields |= set(whole)
    if "rms" in want and same_shape:
        extra["rms_rel_max"] = max(
            abs(g - w) / abs(w) if w else abs(g)
            for g, w in zip(got["rms"], want["rms"]))
    may_differ = tolerance.get("may_differ", fields - set(whole))
    ok = (chunks_equal and same_shape and shares_ok
          and len(differing) <= tolerance.get("slots_differing", 0)
          and fields <= set(may_differ)
          and (per_slot is None or frames_off <= per_slot))
    return {"ok": ok, "chunks_equal": chunks_equal,
            "events_equal": "events" not in whole, "differing": differing,
            "whole_differing": {f: v for f, v in whole.items()
                                if f != "events"},
            "totals": totals, **extra}


def compare_ppm(got: dict | None, want: dict, tolerance: dict) -> dict:
    """Hold a "ppm" step (``_ppm_record``) to the reference's within
    ``tolerance``: {"correction_ppm": the most a correction, the one in
    force and each line's (rounded to 0.001 ppm) may be off by,
    "pll_error_hz": the most each line's PLL error (rounded to 0.1 Hz) may
    be off by, "steps": the most a slot's step may be off by once the
    difference that the corrections' difference makes (2 pi f dppm 1e-6 /
    rate at the slot's frequency f) is taken out}, each default 0. The
    corrections' times, the lines' times and None-ness, and the plan's
    slots, frequencies and bins are held equal. Returns {"ok", "fired"
    (the corrections' times, port's), "correction_ppm_off", "pll_error_hz_off",
    "steps_off", "differing": [what is out of bounds]}."""
    if got is None:
        return {"ok": False, "differing": ["no ppm step"]}
    tol = {k: tolerance.get(k, 0.0) for k in ("correction_ppm",
                                               "pll_error_hz", "steps")}
    differing = []

    def off(pairs):                 # None-ness equal, else the largest gap
        if any((g is None) != (w is None) for g, w in pairs):
            return float("inf")
        return round(max((abs(g - w) for g, w in pairs if g is not None),
                         default=0.0), 9)
    fired = [t for t, _ in got["corrections"]]
    if fired != [t for t, _ in want["corrections"]]:
        differing.append("corrections' times")
    ppm_off = off([(got["correction_ppm"], want["correction_ppm"])]
                  + [(g[1], w[1]) for g, w in zip(got["corrections"],
                                                  want["corrections"])])
    lines = list(zip(got["lines"], want["lines"]))
    if len(got["lines"]) != len(want["lines"]) or any(
            g[0] != w[0] for g, w in lines):
        differing.append("lines' times")
    line_ppm_off = off([(g[1], w[1]) for g, w in lines])
    pll_off = off([(g[2], w[2]) for g, w in lines])
    plan = list(zip(got["plan"], want["plan"]))
    if len(got["plan"]) != len(want["plan"]) or any(
            g[:4] != w[:4] for g, w in plan):
        differing.append("plan's slots, frequencies or bins")
    dppm = got["correction_ppm"] - want["correction_ppm"]
    rate = want["channel_rate"]
    steps_off = max((abs(g[4] - w[4] - 2 * np.pi * w[1] * dppm * 1e-6
                         / rate) for g, w in plan), default=0.0)
    for name, value, bound in (
            ("correction_ppm", max(ppm_off, line_ppm_off),
             tol["correction_ppm"]),
            ("pll_error_hz", pll_off, tol["pll_error_hz"]),
            ("steps", steps_off, tol["steps"])):
        if not value <= bound:
            differing.append(name)
    return {"ok": not differing, "fired": fired,
            "correction_ppm_off": max(ppm_off, line_ppm_off),
            "pll_error_hz_off": pll_off, "steps_off": steps_off,
            "differing": differing}


# the monitor's metrics-line keys held exactly (the rest: the PLL error
# within a bound, the upload's wall-clock ms and MB/s not at all)
MONITOR_METRICS = ("t", "samples", "active_channels", "frames", "events",
                   "audio_segments", "correction_ppm")


# the bytes of one MPEG-1 Layer II frame of the calls the monitor writes
# as mp2 (96 kbps at 32 kHz, no padding: audio/mpeg.py)
MP2_FRAME_BYTES = 432


def mp2_frame_shas(data: bytes) -> list:
    """The sha256 of each MP2_FRAME_BYTES frame of an mp2 call
    (``SLOT_HASH_HEX`` digits)."""
    return [hashlib.sha256(data[i:i + MP2_FRAME_BYTES]).hexdigest()
            [:SLOT_HASH_HEX] for i in range(0, len(data), MP2_FRAME_BYTES)]


def mp2_frames_apart(got: list, want: list) -> int:
    """The frames apart between two calls' frame hashes
    (``mp2_frame_shas``), each missing or extra frame counted."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def mp2_encode(mpeg, pcm) -> bytes:
    """A call's 8 kHz float PCM as the recorder writes it as mp2, through
    `mpeg`, either package's ``audio.mpeg`` module."""
    enc = mpeg.MpegLayer2Encoder(pcm_rate=8000.0)
    return enc.encode(pcm) + enc.flush()


@contextlib.contextmanager
def mp2_pcm_kept(recorder):
    """While the block runs, `recorder` (either package's
    ``audio.recorder`` module) keeps the float32 PCM of each call it
    writes as mp2; yields {call file name: its samples}."""
    pcm = {}
    write = recorder.write_audio_mpeg

    def write_audio_mpeg(path, segment):
        pcm[Path(path).name] = np.asarray(segment.samples, np.float32)
        write(path, segment)
    recorder.write_audio_mpeg = write_audio_mpeg
    try:
        yield pcm
    finally:
        recorder.write_audio_mpeg = write


def mp2_swap(want_calls: list, ref_pcm, own_pcm: dict, encode,
             encode_cpu=None) -> dict:
    """The PCM swap of a monitor's mp2 calls, which tells a departure of
    the port's calls from the reference's (`want_calls`, its digest's)
    as its encoder's or its PCM's: by call name, the PCM's largest
    difference (the port's `own_pcm` against the reference's own
    `ref_pcm`, both {name: float32 samples}; None where the port's is
    missing or of another length), and the reference's PCM through the
    port's encoder (``encode(pcm) -> bytes``) as frames apart from the
    reference's; with `encode_cpu` (the same encoder on the CPU), whether
    the two encoders' bytes are equal."""
    swap = {}
    for call in want_calls:
        name = call["name"]
        ref, own = ref_pcm[name], own_pcm.get(name)
        data = encode(ref)
        row = {"frames": call["frames"],
               "pcm_max_abs": None if own is None or len(own) != len(ref)
               else float(np.abs(own - ref).max()),
               "encoder_apart": mp2_frames_apart(mp2_frame_shas(data),
                                                 call["frame_sha"])}
        if encode_cpu is not None:
            row["encoder_equals_cpu"] = encode_cpu(ref) == data
        swap[name] = row
    return swap


def compare_mp2_swap(swap: dict, tolerance: dict) -> list:
    """What of a PCM swap (``mp2_swap``) is outside ``tolerance``
    ({"mp2_encoder_frames": {call: the most frames the port's encoder on
    the reference's PCM may part by}, "pcm_abs": the most the port's PCM
    may part by}): a list of reasons, empty where it holds. An encoder
    whose bytes on the card are not its bytes on the CPU fails it."""
    bounds = tolerance.get("mp2_encoder_frames", {})
    failed = []
    for name, row in swap.items():
        if row["encoder_apart"] > bounds.get(name, 0):
            failed.append(f"{name}: the encoder parts by "
                          f"{row['encoder_apart']} frames")
        if row["pcm_max_abs"] is None or \
                row["pcm_max_abs"] > tolerance.get("pcm_abs", 0.0):
            failed.append(f"{name}: the PCM parts by {row['pcm_max_abs']}")
        if row.get("encoder_equals_cpu") is False:
            failed.append(f"{name}: the card's encoder is not the CPU's")
    return failed


def monitor_digest(lines, audio_dir, event_log, wave_path) -> dict:
    """What ``monitor`` wrote, in a form both CLIs give: the sha256 of the
    IQ wave it read; its header and summary lines; each metrics line's
    ``MONITOR_METRICS`` and, apart, its ``pll_error_hz``; the event log's
    rows (every field is on the capture's sample clock); each call file in
    audio_dir by name: its sidecar (JSON) and, for a wave, its samples,
    rate, the sha256 of its PCM and the PCM's RMS (of the int16 values
    over 32767, summed in float64), for an mp2 its bytes, frames
    (MP2_FRAME_BYTES each), sha256 and the sha256 of each frame
    (``SLOT_HASH_HEX`` digits); and each bits tap (``*.bits``) by name:
    its bytes and sha256. lines: its stdout lines (the JSON ones are
    read)."""
    import wave

    rows = [json.loads(line) for line in lines if line.startswith("{")]
    metrics = [r for r in rows if "t" in r and "samples" in r]
    calls = []
    for path in sorted(Path(audio_dir).glob("call_*.wav")) + sorted(
            Path(audio_dir).glob("call_*.mp2")):
        call = {"name": path.name,
                "sidecar": json.loads(Path(f"{path}.json").read_text())}
        if path.suffix == ".mp2":
            data = path.read_bytes()
            call.update(
                bytes=len(data), frames=len(data) // MP2_FRAME_BYTES,
                sha256=hashlib.sha256(data).hexdigest(),
                frame_sha=mp2_frame_shas(data))
            calls.append(call)
            continue
        with wave.open(str(path), "rb") as wf:
            rate = wf.getframerate()
            pcm = wf.readframes(wf.getnframes())
        x = np.frombuffer(pcm, "<i2").astype(np.float64) / 32767.0
        calls.append({
            **call, "samples": len(x), "rate": rate,
            "pcm_sha256": hashlib.sha256(pcm).hexdigest(),
            "rms": float(np.sqrt(np.mean(np.square(x)))) if len(x) else 0.0})
    digest = {"wave_sha256": _file_sha(wave_path),
              "header": next(r for r in rows if r.get("monitor")),
              "summary": rows[-1],
              "metrics": [{k: r.get(k) for k in MONITOR_METRICS}
                          for r in metrics],
              "pll_error_hz": [r.get("pll_error_hz") for r in metrics],
              "events": [json.loads(line) for line in
                         Path(event_log).read_text().splitlines()
                         if line.strip()],
              "calls": calls}
    taps = sorted(Path(audio_dir).glob("*.bits"))
    if taps:
        digest["bits"] = {p.name: {"bytes": p.stat().st_size,
                                   "sha256": _file_sha(p)} for p in taps}
    return digest


def _mp2_frames_apart(got: list, want: list) -> dict | None:
    """The mp2 frames that differ between two digests' calls, by call
    name, where the calls are alike but for their frames' bytes (the same
    names, sidecars, byte and frame counts); None where they are not."""
    def shape(calls):
        return [{k: v for k, v in c.items()
                 if k not in ("sha256", "frame_sha")} for c in calls]
    if shape(got) != shape(want):
        return None
    return {w["name"]: mp2_frames_apart(g.get("frame_sha", []),
                                        w.get("frame_sha", []))
            for g, w in zip(got, want) if "frame_sha" in w}


def compare_monitor(got: dict, want: dict, tolerance: dict) -> dict:
    """Hold a monitor run's digest (``monitor_digest``) to the
    reference's: every field equal but ``pll_error_hz``, each line's
    within ``tolerance["pll_error_hz"]`` Hz (present on the same lines),
    and the mp2 calls' frame bytes, of which at most
    ``tolerance["mp2_frames"][call name]`` frames of each call may differ
    (default 0). Returns {"ok", "differing": {field: [got, want]},
    "pll_error_hz_max", "mp2_frames_differing": {call name: frames} or
    None}."""
    differing = {k: [got.get(k), v] for k, v in want.items()
                 if k != "pll_error_hz" and got.get(k) != v}
    apart = _mp2_frames_apart(got["calls"], want["calls"])
    bounds = tolerance.get("mp2_frames", {})
    if apart is not None and all(n <= bounds.get(name, 0)
                                 for name, n in apart.items()):
        differing.pop("calls", None)
    pll = list(zip(got["pll_error_hz"], want["pll_error_hz"]))
    if len(got["pll_error_hz"]) != len(want["pll_error_hz"]) or any(
            (g is None) != (w is None) for g, w in pll):
        differing["pll_error_hz"] = [got["pll_error_hz"],
                                     want["pll_error_hz"]]
    # the lines carry 0.1 Hz steps: a difference is taken to the micro-Hz
    off = round(max((abs(g - w) for g, w in pll if g is not None),
                    default=0.0), 6)
    ok = not differing and off <= tolerance.get("pll_error_hz", 0.0)
    return {"ok": ok, "differing": differing, "pll_error_hz_max": off,
            "mp2_frames_differing": apart}


# ------------------------------------------------------------- scaling

SCALING_M = 64
SCALING_CHANNELS = 56
SCALING_BLOCKS = 8192
SCALING_SIZES = (1, 2, 4, 8)


def _scaling_rank(rank: int, world: int, init_method: str,
                  out_path: str) -> None:
    """One gloo rank of ``scaling_worker``: for each world size s, the
    first s ranks form a group and time the sharded pipeline's build()
    over it, then the same graph without its halo ring and all-to-all,
    each rank with the host's cores split over the s ranks."""
    import torch
    import torch.distributed as dist

    from sdrtrunk_tpu_torch.dsp.channelizer import (Channelizer,
                                                    channelize_core)
    from sdrtrunk_tpu_torch.dsp.extract import (extract_channels,
                                                plan_channels)
    from sdrtrunk_tpu_torch.parallel.pipeline import (
        ShardedChannelizerPipeline)

    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        m = SCALING_M
        fs = m * 12500.0
        ch = Channelizer.design(fs, 12500.0, device="cpu")
        offsets = [(i - m // 2 + 1) * 12500.0
                   for i in range(m - 1)][:SCALING_CHANNELS]
        plan = plan_channels(ch, offsets)
        n = m * SCALING_BLOCKS
        rng = np.random.default_rng(0)
        x = torch.as_tensor((rng.standard_normal(n)
                             + 1j * rng.standard_normal(n)
                             ).astype(np.complex64))
        cores = len(os.sched_getaffinity(0))
        hist = ch.taps_per_channel * m

        def time_fn(fn, xs, group, iters=10, repeats=3):
            fn(xs)                                      # warm-up
            best = None
            for _ in range(repeats):
                dist.barrier(group)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(xs)
                dt = torch.tensor([time.perf_counter() - t0],
                                  dtype=torch.float64)
                dist.all_reduce(dt, dist.ReduceOp.MAX, group)
                best = float(dt) if best is None else min(best, float(dt))
            return n * iters / best / 1e6

        def build_nocomm(r):
            """The same partitioning with the collectives removed (a zero
            halo, the local channel rows of every channel): with against
            without on the same ranks is the collectives' cost."""
            phase0 = torch.zeros((plan.count,), dtype=torch.float32)

            def run(x_local):
                y = channelize_core(torch.cat([torch.zeros(
                    hist, dtype=torch.complex64), x_local]), ch.hmat)
                streams, _ = extract_channels(y, plan, (phase0, 0),
                                              start=r * y.shape[0])
                return streams
            return run

        out, comm_cost = {}, {}
        for s in SCALING_SIZES:
            group = dist.new_group(list(range(s)))
            if rank < s:
                torch.set_num_threads(max(1, cores // s))
                pipe = ShardedChannelizerPipeline(ch, plan, group=group,
                                                  device="cpu")
                xs = x[rank * n // s:(rank + 1) * n // s]
                out[s] = time_fn(pipe.build(), xs, group)
                if s > 1:
                    nocomm = time_fn(build_nocomm(rank), xs, group)
                    comm_cost[s] = 100.0 * (1.0 - out[s] / nocomm)
            dist.barrier()
        if rank == 0:
            base = out[1]
            Path(out_path).write_text(json.dumps({
                "mesh_sizes": list(out),
                "msps_total": out,
                "graph_retention_pct": {k: 100.0 * v / base
                                        for k, v in out.items()},
                "cpu_mesh_collective_cost_pct": comm_cost,
                "cores": cores,
                "note": "gloo ranks on the host's CPU cores, split evenly "
                        "over the s ranks of each size: retention is the "
                        "sharded graph's total against one rank's on the "
                        "same cores; collective_cost_pct compares the "
                        "sharded graph WITH vs WITHOUT its halo ring and "
                        "all_to_all_single on the same ranks",
            }))
    finally:
        dist.destroy_process_group()


def scaling_worker() -> None:
    """Measure the sharded pipeline (parallel/pipeline.py) over gloo ranks
    on the CPU at world sizes 1/2/4/8 (bench.py's virtual-mesh scene: M =
    64, 56 channels, 8192 blocks): eight processes spawned once, the first
    s of them a group for size s. Prints one JSON line."""
    import torch.multiprocessing as mp

    world = max(SCALING_SIZES)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "scaling.json")
        mp.spawn(_scaling_rank, args=(world, "file://" + os.path.join(
            tmp, "rendezvous"), out_path), nprocs=world, join=True)
        print(Path(out_path).read_text(), flush=True)


def collective_accounting(msps_per_card: float) -> dict:
    """Per-step collective byte accounting for the sharded pipeline
    (parallel/pipeline.py) across the 8 cards of one host over NVLink.

    Per chunk of N wideband samples per card the time-sharded graph moves
    exactly two collectives:
      * the halo ring: the channelizer history (taps_per_channel * M
        complex64) from the left neighbour, independent of N;
      * all_to_all_single: the (K, M) bin matrix redistributed so each
        card owns a channel group; each card sends (cards-1)/cards of its
        local output, about N * 8 bytes.
    NVLink 4 carries 450 GB/s each way per H100. One host has no
    data-centre network leg, so none is counted.
    """
    m, taps = 1024, 9
    cards = 8
    n = m * 5120                               # bench chunk per card
    halo_bytes = taps * m * 8
    a2a_bytes = n * 8 * (cards - 1) / cards
    compute_s = n / (msps_per_card * 1e6)
    nvlink_bps = 450e9
    t_link = (halo_bytes + a2a_bytes) / nvlink_bps
    return {
        "chunk_samples_per_card": n,
        "cards": cards,
        "halo_bytes_per_step": halo_bytes,
        "all_to_all_bytes_per_step": int(a2a_bytes),
        "compute_ms_per_step": compute_s * 1e3,
        "nvlink_ms_per_step": t_link * 1e3,
        "predicted_efficiency_nvlink": compute_s / (compute_s + t_link),
        "note": "serialized figures: the collectives could also overlap "
                "compute, so these are lower bounds",
    }


def measure_h2d() -> dict:
    """Host-to-card rate of the link the live loop's ingest uploads over:
    a 10 MiB int8 page-locked host buffer (the orchestrator stages its
    uploads through page-locked buffers) copied to the card, best of 3,
    synchronised; MiB/s."""
    import torch

    from sdrtrunk_tpu_torch import resolve_device

    dev = resolve_device(None)
    h = torch.zeros(10 * 1024 * 1024, dtype=torch.int8)
    if dev.type == "cuda":
        h = h.pin_memory()
    h[:1024].to(dev)
    _sync(dev)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        h.to(dev, non_blocking=True)
        _sync(dev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return {"h2d_mbps": 10.0 / best}


def _last_json(text: str) -> dict:
    return json.loads([line for line in text.strip().splitlines()
                       if line.startswith("{")][-1])


def _error(e: BaseException, stderr: str = "") -> dict:
    tail = stderr.strip().splitlines()[-3:]
    return {"error": (f"{type(e).__name__}: {e}"
                      + (" | " + " | ".join(tail) if tail else ""))[:400]}


def run_isolated(call: str, timeout: int = 600, attempts: int = 2) -> dict:
    """Run one bench function in a fresh interpreter, ``attempts`` times;
    the best attempt by realtime_factor, each attempt's realtime_factor
    (or its error) under ``attempts`` and its seconds under
    ``attempt_wall_s``. Each attempt also measures ``h2d``."""
    best = {"error": "no successful attempt"}
    factors, walls = [], []
    for _ in range(attempts):
        t0 = time.perf_counter()
        stderr = ""
        try:
            proc = subprocess.run(
                [sys.executable, "-c",
                 "import bench_torch, json\n"
                 f"r = bench_torch.{call}\n"
                 "r['h2d'] = bench_torch.measure_h2d()\n"
                 "print(json.dumps(r))"],
                capture_output=True, text=True, timeout=timeout,
                cwd=str(ROOT))
            stderr = proc.stderr
            if proc.returncode:
                raise RuntimeError(f"exit {proc.returncode}")
            result = _last_json(proc.stdout)
        except Exception as e:                  # noqa: BLE001 — bench aux
            result = _error(e, stderr)
        walls.append(time.perf_counter() - t0)
        factors.append(result.get("realtime_factor", result))
        if result.get("realtime_factor", -1) > \
                best.get("realtime_factor", -1):
            best = result
    return {**best, "attempts": factors, "attempt_wall_s": walls}


def measure_cross_process() -> dict:
    """The 1 -> 2 process measurement: the port's multi-process harness
    (parallel/multiprocess.py::worker, --device cpu, blocks=2048) as one
    rank, then as two ranks in two interpreters over gloo."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)

    with tempfile.TemporaryDirectory() as tmp:
        try:
            single = subprocess.run(
                [sys.executable, "-c", (
                    "from sdrtrunk_tpu_torch.parallel.multiprocess import "
                    "worker\n"
                    f"worker({'file://' + tmp + '/one'!r}, 1, 0, "
                    "device='cpu', blocks=2048)\n")],
                cwd=str(ROOT), env=env, capture_output=True, text=True,
                timeout=300)
            if single.returncode:
                raise RuntimeError(f"one rank: exit {single.returncode}: "
                                   f"{single.stderr.strip()[-200:]}")
            base = _last_json(single.stdout)
            procs = [subprocess.Popen(
                [sys.executable, "-m",
                 "sdrtrunk_tpu_torch.parallel.multiprocess",
                 "--init-method", "file://" + tmp + "/two",
                 "--world-size", "2", "--rank", str(i), "--device", "cpu",
                 "--blocks", "2048"],
                cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for i in range(2)]
            results = []
            try:
                for p in procs:
                    out, err = p.communicate(timeout=300)
                    if p.returncode:
                        raise RuntimeError(f"two ranks: exit {p.returncode}"
                                           f": {err.strip()[-200:]}")
                    results.append(_last_json(out))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            total = sum(r["msps_per_process"] for r in results)
            return {
                "msps_1p": base["msps_per_process"],
                "msps_2p_total": total,
                "efficiency": total / base["msps_per_process"],
                "ok": bool(base["ok"] and all(r["ok"] for r in results)),
                "note": "two interpreters over gloo on the host's shared "
                        "cores against one; across cards the collectives "
                        "ride NVLink (see collective_accounting)",
            }
        except Exception as e:                  # noqa: BLE001 — bench aux
            return _error(e)


def measure_scaling() -> dict:
    try:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench_torch.py"), "--scaling-worker"],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT))
        if proc.returncode:
            raise RuntimeError(f"exit {proc.returncode}: "
                               f"{proc.stderr.strip()[-200:]}")
        return _last_json(proc.stdout)
    except Exception as e:                      # noqa: BLE001 — bench aux
        return _error(e)


# ------------------------------------------------------------- smoke

def _require_cuda(what: str) -> None:
    """Raise unless CUDA is available and the default device is the card
    (``--platform cpu`` of the CLI makes it the CPU)."""
    import torch

    from sdrtrunk_tpu_torch import default_device
    if not torch.cuda.is_available() \
            or torch.device(default_device()).type != "cuda":
        raise RuntimeError(f"bench_torch: {what} runs on a CUDA card, and "
                           "torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()} with the default "
                           f"device {default_device()!r} (--small runs on "
                           "the CPU)")


def smoke() -> int:
    """One representative of each kernel family run on the card and on the
    CPU, outputs compared with bench.py's tolerances: the channelizer, the
    DQPSK kernel (decision-directed) and the Gardner kernel through the
    per-channel call (``tree.per_channel``), the bit-timing kernel through
    the LTR FSK demodulator, the de-emphasis IIR, the polyphase resampler
    and the two-channel synthesizer's rotation. Returns 1 on any
    failure."""
    _require_cuda("--smoke")
    import torch

    from sdrtrunk_tpu_torch.dsp import fir, iir
    from sdrtrunk_tpu_torch.dsp.channelizer import (Channelizer,
                                                    channelize_core)
    from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator
    from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator,
                                            GardnerDQPSKDemodulator)
    from sdrtrunk_tpu_torch.dsp.synthesizer import rot4
    from sdrtrunk_tpu_torch.signal import generators

    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    failures = 0

    def run_both(fn, *args):
        """fn(device, *tensors) on the card and on the CPU -> numpy
        outputs of each."""
        outs = []
        for d in (dev, cpu):
            got = fn(d, *[torch.as_tensor(a, device=d) for a in args])
            outs.append([o.cpu().numpy() for o in got])
        return outs

    def report(name, ok, detail=""):
        nonlocal failures
        if not ok:
            failures += 1
        print(json.dumps({"smoke": name, "ok": bool(ok),
                          "device": torch.cuda.get_device_name(dev),
                          "detail": detail}), flush=True)

    # channelizer
    hmat = Channelizer.design(32 * 12500.0, 12500.0, device="cpu").hmat
    x2 = rng.standard_normal((32 * 256, 2)).astype(np.float32)

    def k_chan(d, x2):
        y = channelize_core(torch.view_as_complex(x2), hmat.to(d))
        return (y.real, y.imag)
    g, c = run_both(k_chan, x2)
    err = max(float(np.abs(g[0] - c[0]).max()),
              float(np.abs(g[1] - c[1]).max()))
    report("channelizer", err < 1e-2, f"max_abs_err={err:.2e}")

    # the symbol loops on clean modem signals: compare dibit agreement
    tx = rng.integers(0, 4, 600).astype(np.uint8)
    for name, cls, mod in (
            ("dqpsk_decision", DQPSKDemodulator,
             generators.c4fm_modulate(tx, 25000.0)),
            ("dqpsk_gardner", GardnerDQPSKDemodulator,
             generators.lsm_modulate(tx, 25000.0))):
        iqp = np.stack([mod.real, mod.imag], -1).astype(np.float32)

        def k_psk(d, x2, cls=cls):
            demod = cls(sample_rate=25000.0, device=d)
            dib, val, _ = demod(torch.view_as_complex(x2))
            return (dib, val)
        g, c = run_both(k_psk, iqp)
        dd, dc = g[0][g[1]], c[0][c[1]]
        n = min(len(dd), len(dc))
        agree = float(np.mean(dd[:n] == dc[:n])) if n else 0.0
        report(name, agree > 0.995 and abs(len(dd) - len(dc)) <= 2,
               f"agreement={agree:.4f} n={n}")

    # zero-crossing FSK bit timing
    audio = generators.awgn(np.sign(np.sin(
        2 * np.pi * 150.0 * np.arange(8000) / 8000.0)), 30.0, rng
        ).astype(np.float32)

    def k_fsk(d, a):
        sym, val, _ = LTRFSKDemodulator(device=d)(a)
        return (sym, val)
    g, c = run_both(k_fsk, audio)
    ok = np.array_equal(g[0][g[1]], c[0][c[1]])
    report("fsk_zero_crossing", ok,
           f"n={int(g[1].sum())} vs {int(c[1].sum())}")

    # IIR (de-emphasis)
    a = rng.standard_normal(4096).astype(np.float32)

    def k_iir(d, a):
        y, _ = iir.deemphasis(a[None], 8000.0)
        return (y[0],)
    g, c = run_both(k_iir, a)
    err = float(np.abs(g[0] - c[0]).max())
    report("iir_deemphasis", err < 1e-3, f"max_abs_err={err:.2e}")

    # polyphase resampler
    taps = np.asarray(fir.resample_taps(4, 25), np.float32)

    def k_res(d, a, taps):
        return (fir.polyphase_resample(a[None], taps, 4, 25)[0],)
    g, c = run_both(k_res, a, taps)
    err = float(np.abs(g[0] - c[0]).max())
    report("polyphase_resample", err < 1e-2, f"max_abs_err={err:.2e}")

    # two-channel synthesizer
    z2 = rng.standard_normal((256, 4)).astype(np.float32)

    def k_syn(d, z2):
        lo = torch.complex(z2[:, 0], z2[:, 1])
        hi = torch.complex(z2[:, 2], z2[:, 3])
        rot = rot4(d)[torch.arange(256, device=d) % 4]
        z = rot * lo - torch.conj(rot) * hi
        return (z.real, z.imag)
    g, c = run_both(k_syn, z2)
    err = max(float(np.abs(g[0] - c[0]).max()),
              float(np.abs(g[1] - c[1]).max()))
    report("two_channel_synthesizer", err < 1e-4, f"max_abs_err={err:.2e}")

    print(json.dumps({"smoke_summary": "PASS" if failures == 0 else "FAIL",
                      "failures": failures}), flush=True)
    return 1 if failures else 0


# ------------------------------------------------------------- main

def _host() -> dict:
    """The host's usable cores, CPU model and architecture: lscpu's model
    name, else /proc/cpuinfo's (an x86 'model name', an Arm 'CPU part')."""
    import platform
    lines = []
    try:
        lines = subprocess.run(["lscpu"], capture_output=True, text=True,
                               timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        lines += Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        pass
    model = next((line.split(":", 1)[1].strip() for key in
                  ("Model name", "model name", "CPU part") for line in lines
                  if line.startswith(key)), None)
    return {"cores": len(os.sched_getaffinity(0)), "cpu": model,
            "machine": platform.machine()}


def _device() -> dict:
    import torch
    if not torch.cuda.is_available():
        return {"name": "cpu", "power_limit": None, "count": 0}
    card = _card() or ""
    return {"name": torch.cuda.get_device_name(0),
            "power_limit": card.rsplit(",", 1)[-1].strip() or None,
            "count": torch.cuda.device_count()}


def _errors(tree, path="") -> list:
    """The paths in a result tree that hold an ``error``."""
    if not isinstance(tree, dict):
        return []
    found = [path or "."] if "error" in tree else []
    for key, value in tree.items():
        if isinstance(value, list):
            for i, v in enumerate(value):
                found += _errors(v, f"{path}.{key}[{i}]")
        else:
            found += _errors(value, f"{path}.{key}")
    return found


def _leg(walls: dict, name: str, fn):
    """Run one leg, its seconds into walls[name]; an auxiliary leg's
    exception becomes its {"error": ...} record."""
    t0 = time.perf_counter()
    try:
        return fn()
    except Exception as e:                      # noqa: BLE001 — bench aux
        return _error(e)
    finally:
        walls[name] = time.perf_counter() - t0


def _bench(small: bool, profile: bool) -> int:
    walls = {}
    if small:
        m, blocks, iters = 64, 128, 3
        c4fm_blocks = 64
    else:
        # 5120 blocks -> 5.24 MS chunks (0.41 s of signal), the chunk every
        # live cell runs; per-channel T = 10240. 24 state-chained
        # iterations.
        m, blocks, iters = 1024, 5120, 24
        c4fm_blocks = 5120

    profile_dir = (os.path.join(tempfile.gettempdir(),
                                "sdrtrunk_tpu_torch_trace")
                   if profile else None)
    dispatch = (_leg(walls, "dispatch_overhead", measure_dispatch_overhead)
                if not small else None)
    t0 = time.perf_counter()
    nbfm, rx = bench_receiver("nbfm", m, blocks, iters, "audio",
                              profile_dir)
    walls["nbfm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c4fm, _ = bench_receiver("c4fm", m, c4fm_blocks, iters, "power_db")
    walls["c4fm"] = time.perf_counter() - t0
    skipped = {"skipped": "small"}
    if small:
        # the CPU runs the symbol loop's plain per-sample version, so the
        # quick variant times 2 chunks, not 20
        orchestrator = _leg(walls, "orchestrator",
                            lambda: bench_orchestrator(iters=2))
        orchestrator_bank = orchestrator_bank_int4 = \
            orchestrator_bank_nbfm = orchestrator_bank_dmr = \
            orchestrator_bank_p25p2 = protocols = kernel_cmp = \
            cross_process = skipped
    else:
        # a fresh interpreter per live-loop bench: the product runs as its
        # own process
        orchestrator = _leg(walls, "orchestrator",
                            lambda: run_isolated("bench_orchestrator()"))
        orchestrator_bank = _leg(
            walls, "orchestrator_bank_c4fm_1023",
            lambda: run_isolated("bench_orchestrator_bank(timed_chunks=6)"))
        orchestrator_bank_int4 = _leg(
            walls, "orchestrator_bank_c4fm_int4_1023",
            lambda: run_isolated(
                "bench_orchestrator_bank(timed_chunks=6, ingest='int4')"))
        orchestrator_bank_nbfm = _leg(
            walls, "orchestrator_bank_nbfm_1023",
            lambda: run_isolated(
                "bench_orchestrator_bank_nbfm(timed_chunks=6)"))
        orchestrator_bank_dmr = _leg(
            walls, "orchestrator_bank_dmr_1023",
            lambda: run_isolated(
                "bench_orchestrator_bank_dmr(timed_chunks=6)"))
        orchestrator_bank_p25p2 = _leg(
            walls, "orchestrator_bank_p25p2_1023",
            lambda: run_isolated(
                "bench_orchestrator_bank_p25p2(timed_chunks=6)"))
        protocols = _leg(walls, "digital_protocols", bench_digital_protocols)
        kernel_cmp = _leg(walls, "kernel_vs_plain", bench_kernel_vs_plain)
        cross_process = _leg(walls, "cross_process", measure_cross_process)
    scaling = _leg(walls, "scaling", measure_scaling)
    roofline = roofline_nbfm(rx, nbfm["msps"])
    collectives = collective_accounting(c4fm["msps"])

    result = {
        "metric": "iq_msps_per_chip",
        "value": nbfm["msps"],
        "unit": "Msamples/s",
        "vs_baseline": nbfm["msps"] / 10.0,
        "detail": {
            "device": _device(),
            "host": _host(),
            "nbfm": nbfm,
            "c4fm_msps_per_chip": c4fm["msps"],
            "c4fm": c4fm,
            "roofline": roofline,
            "mfu": roofline["mfu"],
            "orchestrator": orchestrator,
            "orchestrator_bank_c4fm_1023": orchestrator_bank,
            "orchestrator_bank_c4fm_int4_1023": orchestrator_bank_int4,
            "orchestrator_bank_nbfm_1023": orchestrator_bank_nbfm,
            "orchestrator_bank_dmr_1023": orchestrator_bank_dmr,
            "orchestrator_bank_p25p2_1023": orchestrator_bank_p25p2,
            "digital_protocols": protocols,
            "kernel_vs_plain": kernel_cmp,
            "dispatch_overhead": dispatch,
            "scaling": scaling,
            "cross_process": cross_process,
            "collective_accounting": collectives,
            "leg_wall_s": walls,
        },
    }
    if profile_dir:
        result["detail"]["profile_trace"] = profile_dir
    print(json.dumps(result), flush=True)
    # the compact headline printed last: a reader of the tail of stdout
    # gets every headline key
    headline = {
        "metric": "iq_msps_per_chip",
        "value": nbfm["msps"],
        "unit": "Msamples/s",
        "vs_baseline": nbfm["msps"] / 10.0,
        "nbfm_msps": nbfm["msps"],
        "c4fm_msps": c4fm["msps"],
        "mfu": roofline["mfu"],
        "live_c4fm_rt": orchestrator_bank.get("realtime_factor"),
        "live_c4fm_int4_rt": orchestrator_bank_int4.get("realtime_factor"),
        "live_c4fm_h2d_mbps": (orchestrator_bank.get("h2d") or {}
                               ).get("h2d_mbps"),
        "live_nbfm_rt": orchestrator_bank_nbfm.get("realtime_factor"),
        "live_dmr_rt": orchestrator_bank_dmr.get("realtime_factor"),
        "live_p25p2_rt": orchestrator_bank_p25p2.get("realtime_factor"),
        "scaling_retention_pct": scaling.get("graph_retention_pct"),
        "nvlink_predicted_efficiency": collectives[
            "predicted_efficiency_nvlink"],
    }
    print(json.dumps(headline), flush=True)
    errors = _errors(result["detail"])
    if errors:
        print(f"bench_torch: legs with an error: {', '.join(errors)}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    """bench.py's flags from sys.argv; returns the exit code."""
    if "--scaling-worker" in sys.argv:
        scaling_worker()
        return 0
    if "--smoke" in sys.argv:
        return smoke()
    small = "--small" in sys.argv
    profile = "--profile" in sys.argv
    if small:
        from sdrtrunk_tpu_torch import use_device
        with use_device("cpu"):
            return _bench(small, profile)
    _require_cuda("the full bench")
    return _bench(small, profile)


if __name__ == "__main__":
    sys.exit(main())
