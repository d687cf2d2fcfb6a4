#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sdrtrunk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, each of which raises on
failure (the exit code is then not 0):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the DQPSK kernel from sdrtrunk_tpu_torch/csrc/dqpsk.cu;
3. kernel against its plain PyTorch version on the card, at the live
   bank's shape (1023 channels x 10240 samples): identical on the signal
   channels, with both times measured by CUDA events;
4. the live loop at the product's full width: 12.8 MS/s of int8 IQ,
   1024 bins, 1023 slots (a P25 control channel granting a traffic
   channel, one free slot for the grant, 1021 voice slots), through
   Orchestrator(device="cuda").run() for 3 warm-up and 4 timed chunks of
   0.41 s. It must follow the grant, decode frames on >= 99% of the voice
   slots, produce audio and launch the kernel once per chunk.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FS = 12_800_000.0
M = 1024
SLOTS = 1023
CHUNK_BLOCKS = 5120
WARMUP, TIMED = 3, 4
CENTER_HZ = 460_000_000.0
TRAFFIC_INDEX = 600              # the granted channel's slot offset index
GROUP, SOURCE = 0x457, 0xABCDE
KERNEL_C, KERNEL_T = 1023, 10240
NOISE_CHANNELS = 8
STATE_TOL = 1e-4


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _cuda_ms(fn, reps: int = 1) -> float:
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --- phase 3: the kernel against its plain version -----------------------

def check_kernel(card: str) -> dict:
    import numpy as np
    import torch

    from sdrtrunk_tpu.signal.generators import (awgn, c4fm_modulate,
                                                random_dibits)
    from sdrtrunk_tpu_torch.dsp import dqpsk_cuda
    from sdrtrunk_tpu_torch.dsp.psk import DQPSKDemodulator, DQPSKState

    c, t = KERNEL_C, KERNEL_T
    rng = np.random.default_rng(1)
    bases = [c4fm_modulate(random_dibits(t // 5 + 2400, seed=s), 25000.0)
             for s in range(4)]
    rows = []
    for ch in range(c - NOISE_CHANNELS):
        base = bases[ch % 4]
        s = int(rng.integers(0, len(base) - t))
        rows.append(awgn(base[s:s + t], 30.0, rng=rng))
    noise = (rng.standard_normal((NOISE_CHANNELS, t))
             + 1j * rng.standard_normal((NOISE_CHANNELS, t))) * 0.5
    x = torch.as_tensor(np.concatenate([np.stack(rows), noise])
                        .astype(np.complex64), device="cuda")
    demod = DQPSKDemodulator(25000.0, device="cuda")
    s0 = DQPSKState(*[a.expand((c,) + a.shape).clone()
                      for a in demod.init_state()])

    d_k, v_k, s_k = demod.batched(x, s0)                 # the kernel
    torch.cuda.synchronize()
    plain = {}

    def run_plain():
        plain["out"] = demod.scan_batched(x, s0)
    plain_ms = _cuda_ms(run_plain)
    d_p, v_p, s_p = plain["out"]
    kernel_ms = _cuda_ms(lambda: dqpsk_cuda.dqpsk_cuda(demod, x, s0), reps=5)

    sig = slice(0, c - NOISE_CHANNELS)
    same = ((v_k == v_p) & ((d_k == d_p) | ~v_k)).all(dim=1).cpu()
    errs = {}
    for name, a, b in zip(DQPSKState._fields, s_k, s_p):
        diff = (a - b).abs()
        errs[name] = float(diff[sig].max())
        if errs[name] > STATE_TOL:
            raise AssertionError(f"kernel state {name} differs by "
                                 f"{errs[name]} on signal channels")
    if not bool(same[sig].all()):
        bad = (~same[sig]).nonzero().flatten().tolist()[:10]
        raise AssertionError(f"kernel symbols differ on signal channels {bad}")
    if float(v_k[sig].float().mean()) < 0.15:
        raise AssertionError("kernel produced too few symbols")
    print(f"[kernel] {card}: dqpsk C={c} T={t}: identical on "
          f"{int(same.sum())}/{c} channels (signal {int(same[sig].sum())}/"
          f"{c - NOISE_CHANNELS}); max state err {max(errs.values())}; "
          f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    return {"name": "dqpsk", "route": "cuda",
            "source": "sdrtrunk_tpu_torch/csrc/dqpsk.cu",
            "replaces": "sdrtrunk_tpu/dsp/pallas_psk.py:48",
            "max_abs_err": max(errs.values()), "ms": kernel_ms,
            "plain_ms": plain_ms}


# --- phase 4: the full-width live loop ------------------------------------

def _p25_streams(total_dibits: int, base_hz: float):
    """(control, traffic, voice superframe) dibit streams."""
    import numpy as np

    from sdrtrunk_tpu.protocol.bits import from_int
    from sdrtrunk_tpu.protocol.p25p1.duid import DUID
    from sdrtrunk_tpu.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_tpu.protocol.p25p1.hdu import hdu_encode, tdulc_encode
    from sdrtrunk_tpu.protocol.p25p1.lc import lc_build_group_voice
    from sdrtrunk_tpu.protocol.p25p1.ldu import ldu1_encode, ldu2_encode
    from sdrtrunk_tpu.protocol.p25p1.tsbk import tsbk_encode

    rng = np.random.default_rng(11)
    asm = P25P1FrameAssembler(nac=0x293)
    iden = np.zeros(64, np.uint8)              # IDEN_UP, tsbk.py:348-355
    iden[0:4] = from_int(1, 4)
    iden[4:13] = from_int(100, 9)              # bandwidth 12.5 kHz
    iden[22:32] = from_int(100, 10)            # spacing 12.5 kHz
    iden[32:64] = from_int(int(base_hz / 5), 32)
    grant = np.zeros(64, np.uint8)             # GROUP_VOICE_CHANNEL_GRANT
    grant[8:12] = from_int(1, 4)
    grant[12:24] = from_int(TRAFFIC_INDEX, 12)
    grant[24:40] = from_int(GROUP, 16)
    grant[40:64] = from_int(SOURCE, 24)
    t_iden = asm.assemble(DUID.TSBK, tsbk_encode(0x3D, iden))
    t_grant = asm.assemble(DUID.TSBK, tsbk_encode(0x00, grant))
    t_rfss = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    parts = [rng.integers(0, 4, 120).astype(np.uint8), t_iden, t_iden,
             t_grant, t_grant]
    while sum(len(p) for p in parts) < total_dibits - 2 * len(t_grant):
        parts += [t_rfss, t_grant]
    control = np.concatenate(parts)

    lc = lc_build_group_voice(group=GROUP, source=SOURCE)
    call = [asm.assemble(DUID.HDU, hdu_encode(np.zeros(72, np.uint8), 0,
                                              0x80, 0, talkgroup=GROUP))]
    call += [asm.assemble(DUID.LDU1, ldu1_encode(
        lc, rng.integers(0, 2, (9, 144)).astype(np.uint8))) for _ in range(4)]
    call.append(asm.assemble(DUID.TDULC, tdulc_encode(lc)))
    start = int(1.3 * 4800)                    # after the grant's latency
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


def synthesize_capture(ch, offsets, total_chunks: int) -> list:
    """int8 (n, 2) chunks of the 1023-slot capture, synthesized on the card
    by the port's synthesis bank with filter state carried across chunks
    (each chunk re-synthesizes the previous one's last 2T blocks, which
    equals one-shot synthesis)."""
    import numpy as np
    import torch

    from sdrtrunk_tpu.signal.generators import c4fm_modulate
    from sdrtrunk_tpu_torch.dsp.synthesizer import synthesize_bank

    chunk = M * CHUNK_BLOCKS
    k = 2 * chunk // M
    rate = ch.channel_sample_rate
    n_ch = (total_chunks + 1) * k
    total_dibits = int(n_ch / rate * 4800) + 64
    control, traffic, superframe = _p25_streams(
        total_dibits, CENTER_HZ + offsets[0])
    rng = np.random.default_rng(0)
    starts = rng.integers(0, len(superframe) * 5, SLOTS)
    need = int(starts.max()) + n_ch + len(superframe)
    voice = np.tile(superframe, need // (len(superframe) * 5) + 2)
    base = torch.as_tensor(c4fm_modulate(voice, rate).astype(np.complex64),
                           device="cuda")
    streams = base[torch.as_tensor(starts, device="cuda")[:, None]
                   + torch.arange(n_ch, device="cuda")[None, :]]
    for row, dib in ((0, control), (TRAFFIC_INDEX, traffic)):
        streams[row] = torch.as_tensor(
            c4fm_modulate(dib, rate)[:n_ch].astype(np.complex64),
            device="cuda")
    bins = torch.as_tensor([ch.channel_for_frequency(o) for o in offsets],
                           device="cuda")
    pad = 2 * ch.taps_per_channel
    half = M // 2
    tail = torch.zeros((pad, M), dtype=torch.complex64, device="cuda")
    xs = []
    for j in range(total_chunks):
        u = torch.zeros((pad + k, M), dtype=torch.complex64, device="cuda")
        u[:pad] = tail
        u[pad:, bins] = streams[:, j * k:(j + 1) * k].T * 0.5
        tail = u[-pad:].clone()
        xs.append(synthesize_bank(u, ch.hmat)[pad * half: pad * half + chunk])
    peak = max(float(torch.view_as_real(x).abs().max()) for x in xs)
    return [torch.clamp(torch.round(torch.view_as_real(x) * (118.0 / peak)),
                        -127, 127).to(torch.int8).cpu().numpy() for x in xs]


def layer_times(orch, iq8) -> dict:
    """Per-chunk device ms of each layer of the live step, on one chunk,
    from a copy of the running state (CUDA events)."""
    import torch

    from sdrtrunk_tpu_torch.convert import tree_map
    from sdrtrunk_tpu_torch.dsp.channelizer import channelize_core
    from sdrtrunk_tpu_torch.dsp.dqpsk_cuda import dqpsk_cuda
    from sdrtrunk_tpu_torch.dsp.psk import unpack_symbols
    from sdrtrunk_tpu_torch.receiver import dynamic_select_mix
    from sdrtrunk_tpu_torch.runtime.orchestrator import (
        compact_and_correlate, ingest)

    rx = orch.rx
    state = tree_map(lambda a: a.clone(), orch.state)
    bins, steps = (torch.as_tensor(orch.bins, dtype=torch.long,
                                   device="cuda"),
                   torch.as_tensor(orch.steps, device="cuda"))
    x = torch.as_tensor(iq8, device="cuda")
    r = {}

    def chan():
        xc = torch.view_as_complex(ingest(x).contiguous())
        r["y"] = channelize_core(torch.cat([state["chan"], xc]),
                                 rx.channelizer.hmat)

    def select():
        r["streams"], _ = dynamic_select_mix(
            r["y"], state["rot"], state["mixer_phase"], bins, steps, rx.rot4)

    def front():
        (r["leveled"], _), _ = rx.decoder._front(r["streams"], state["dec"])

    def kernel():
        r["packed"], _ = dqpsk_cuda(rx.decoder.demod, r["leveled"],
                                    state["dec"]["psk"])

    def tail():
        compact_and_correlate(*unpack_symbols(r["packed"]), orch._bank_cap)

    out = {}
    for name, fn in (("ingest_channelize", chan), ("select_mix", select),
                     ("front_end", front), ("dqpsk_kernel", kernel),
                     ("tail", tail)):
        fn()
        out[name] = _cuda_ms(fn, reps=3)
    return out


def run_live(card: str) -> dict:
    import numpy as np
    import torch

    from sdrtrunk_tpu.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.dsp import dqpsk_cuda
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    chunk = M * CHUNK_BLOCKS
    ch = Channelizer.design(FS, 12500.0, device="cuda")
    assert ch.channels == M
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(SLOTS)]
    t0 = time.perf_counter()
    chunks = synthesize_capture(ch, offsets, WARMUP + TIMED)
    synth_s = time.perf_counter() - t0

    pos = 0

    def source(num):
        nonlocal pos
        j = pos // chunk
        pos += num
        return chunks[j] if j < len(chunks) else None

    orch = Orchestrator(source, FS, CENTER_HZ, [offsets[0]], slots=SLOTS,
                        decoder="c4fm", chunk_samples=chunk,
                        idle_teardown_seconds=1e9, ppm_correction=False,
                        device="cuda")
    traffic_hz = CENTER_HZ + offsets[TRAFFIC_INDEX]
    voice_hz = [CENTER_HZ + o for i, o in enumerate(offsets)
                if i not in (0, TRAFFIC_INDEX)]
    for f in voice_hz:
        orch._activate(f, IdentifierCollection())
    if sum(s.active for s in orch.slots) != SLOTS - 1:
        raise AssertionError("voice slots did not all activate")

    devices = set()
    step = orch.step

    def spy_step(*args):
        out, st = step(*args)
        devices.update(v.device.type for v in out.values())
        return out, st
    orch.step = spy_step
    framing = {"s": 0.0}
    frame_chunk = orch.bank_proc.frame_chunk

    def timed_frame_chunk(*args):
        f0 = time.perf_counter()
        try:
            return frame_chunk(*args)
        finally:
            framing["s"] += time.perf_counter() - f0
    orch.bank_proc.frame_chunk = timed_frame_chunk

    dqpsk_cuda.dqpsk_cuda.launches = 0          # count the main path only
    orch.run(max_chunks=WARMUP)
    torch.cuda.synchronize()
    framing["s"] = 0.0
    t0 = time.perf_counter()
    metrics = orch.run(max_chunks=TIMED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dqpsk_cuda.dqpsk_cuda.launches

    status = orch.channel_status()
    by_freq = {s["frequency_hz"]: s for s in status}
    voice_frames = np.array([by_freq[f]["frames"] for f in voice_hz])
    traffic = by_freq.get(traffic_hz)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    msps = chunk * TIMED / elapsed / 1e6
    layers = layer_times(orch, chunks[-1])
    result = {
        "card": card, "slots": SLOTS, "wideband_msps": FS / 1e6,
        "chunk_samples": chunk, "timed_chunks": TIMED,
        "msps": msps, "realtime_factor": msps * 1e6 / FS,
        "frames": int(sum(s["frames"] for s in status)),
        "voice_slots_with_frames": int((voice_frames > 0).sum()),
        "voice_slots": len(voice_hz),
        "traffic_frames": None if traffic is None else traffic["frames"],
        "events": len(orch.events), "audio_segments": len(segs),
        "skipped_grants": len(orch.skipped_grants),
        "active_channels": metrics.get("active_channels"),
        "kernel_launches": launches,
        "device_ms_per_chunk": layers,
        "host_framing_ms_per_chunk": framing["s"] * 1e3 / TIMED,
        "synthesis_s": synth_s,
    }
    print("[live] " + json.dumps(result), flush=True)
    if traffic is None or not any(s.active and s.frequency_hz == traffic_hz
                                  for s in orch.slots):
        raise AssertionError("the grant did not activate the traffic slot")
    if not traffic["frames"]:
        raise AssertionError("no frames decoded on the granted slot")
    if (voice_frames > 0).mean() < 0.99:
        raise AssertionError(f"frames on only {(voice_frames > 0).sum()} of "
                             f"{len(voice_hz)} voice slots")
    if not segs:
        raise AssertionError("no AudioSegment")
    if launches != WARMUP + TIMED:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{WARMUP + TIMED} chunks")
    if devices != {"cuda"}:
        raise AssertionError(f"live step outputs on {devices}")
    return result


def main() -> int:
    if not (ROOT / "sdrtrunk_tpu_torch").is_dir() \
            or not (ROOT / "sdrtrunk_tpu").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)

    from sdrtrunk_tpu_torch.dsp import dqpsk_cuda
    t0 = time.perf_counter()
    dqpsk_cuda.build()
    print(f"[build] dqpsk kernel built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    kernel = check_kernel(card)
    live = run_live(card)
    kernel["launches"] = live["kernel_launches"]
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
